"""whisper-tiny [audio] -- 4L(enc)+4L(dec) d_model=384 6H (kv=6) d_ff=1536
vocab=51865; enc-dec, conv frontend STUB [arXiv:2212.04356].

The audio frontend is a stub: ``input_specs`` provides precomputed frame
embeddings (B, 1500, 384) (Whisper's 30 s -> 1500 frames).  6 heads do not
divide the 16-way model axis -> attention weight replication fallback
(tiny model; benign).
"""
from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv=6,
    d_ff=1536,
    vocab=51865,
    head_dim=64,
    act="gelu",
    gated_mlp=False,
    pattern=(LayerSpec(mixer="attn"),),
    norm="ln",
    qkv_bias=True,
    tie_embed=True,
    enc_dec=True,
    enc_frames=1500,
)

SMOKE = ArchConfig(
    name="whisper-tiny-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=128,
    vocab=512,
    head_dim=16,
    act="gelu",
    gated_mlp=False,
    pattern=(LayerSpec(mixer="attn"),),
    norm="ln",
    qkv_bias=True,
    tie_embed=True,
    enc_dec=True,
    enc_frames=12,
    kv_chunk=64,
)
