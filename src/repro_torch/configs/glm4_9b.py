"""glm4-9b [dense] -- 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552; RoPE, GQA, QKV bias [hf:THUDM/glm-4-9b]."""
from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv=2,
    d_ff=13696,
    vocab=151552,
    head_dim=128,
    act="silu",
    pattern=(LayerSpec(mixer="attn"),),
    tie_embed=False,
    qkv_bias=True,
    rope_theta=10000.0,
)

SMOKE = ArchConfig(
    name="glm4-9b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=128,
    vocab=512,
    head_dim=16,
    act="silu",
    pattern=(LayerSpec(mixer="attn"),),
    tie_embed=False,
    qkv_bias=True,
    kv_chunk=64,
)
