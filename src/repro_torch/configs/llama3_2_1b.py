"""llama3.2-1b [dense] -- 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256; small llama3 [hf:meta-llama/Llama-3.2-1B; unverified]."""
from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv=8,
    d_ff=8192,
    vocab=128256,
    head_dim=64,
    act="silu",
    pattern=(LayerSpec(mixer="attn"),),
    tie_embed=True,
    rope_theta=500000.0,
)

SMOKE = ArchConfig(
    name="llama3.2-1b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv=2,
    d_ff=128,
    vocab=512,
    head_dim=8,
    act="silu",
    pattern=(LayerSpec(mixer="attn"),),
    tie_embed=True,
    kv_chunk=64,
)
