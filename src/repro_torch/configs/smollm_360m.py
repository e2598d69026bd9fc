"""smollm-360m [dense] -- 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152; llama-arch small [hf:HuggingFaceTB/SmolLM]."""
from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv=5,
    d_ff=2560,
    vocab=49152,
    head_dim=64,
    act="silu",
    pattern=(LayerSpec(mixer="attn"),),
    tie_embed=True,
    rope_theta=10000.0,
)

SMOKE = ArchConfig(
    name="smollm-360m-smoke",
    family="dense",
    n_layers=2,
    d_model=60,
    n_heads=3,
    n_kv=1,
    d_ff=128,
    vocab=512,
    head_dim=20,
    act="silu",
    pattern=(LayerSpec(mixer="attn"),),
    tie_embed=True,
    kv_chunk=64,
)
