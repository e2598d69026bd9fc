"""gemma-2b [dense] -- 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000; GeGLU, head_dim=256, sqrt(d) embedding scale
[arXiv:2403.08295]."""
from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv=1,
    d_ff=16384,
    vocab=256000,
    head_dim=256,
    act="gelu",
    pattern=(LayerSpec(mixer="attn"),),
    tie_embed=True,
    embed_scale=True,
    rope_theta=10000.0,
)

SMOKE = ArchConfig(
    name="gemma-2b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=1,
    d_ff=128,
    vocab=512,
    head_dim=32,
    act="gelu",
    pattern=(LayerSpec(mixer="attn"),),
    tie_embed=True,
    embed_scale=True,
    kv_chunk=64,
)
