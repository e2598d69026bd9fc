"""phi-3-vision-4.2b [vlm] -- 32L d_model=3072 32H (MHA kv=32) d_ff=8192
vocab=32064 [hf:microsoft/Phi-3-vision-128k-instruct].

The CLIP frontend is a STUB per the brief: ``input_specs`` provides
precomputed patch embeddings (B, 576, d_model) that are prepended to the
token embeddings (576 = (336/14)^2 CLIP-L patches).
"""
from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv=32,
    d_ff=8192,
    vocab=32064,
    head_dim=96,
    act="silu",
    pattern=(LayerSpec(mixer="attn"),),
    tie_embed=False,
    rope_theta=10000.0,
    vlm_patches=576,
)

SMOKE = ArchConfig(
    name="phi-3-vision-4.2b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=128,
    vocab=512,
    head_dim=16,
    act="silu",
    pattern=(LayerSpec(mixer="attn"),),
    tie_embed=False,
    vlm_patches=4,
    kv_chunk=64,
)
