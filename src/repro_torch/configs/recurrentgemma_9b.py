"""recurrentgemma-9b [hybrid] -- 38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000; RG-LRU + local attention in a 2:1 pattern
[arXiv:2402.19427 Griffin].

38 layers = 12 x (rec, rec, local-attn[2048]) + tail (rec, rec).  Decode
state is O(1) per rec layer and O(window) per attention layer -> runs
long_500k.
"""
from repro_torch.models.transformer import ArchConfig, LayerSpec

_REC = LayerSpec(mixer="rec")
_ATT = LayerSpec(mixer="attn", window=2048)

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    act="gelu",
    pattern=(_REC, _REC, _ATT),
    rnn_width=4096,
    tie_embed=True,
    embed_scale=True,
    rope_theta=10000.0,
)

SMOKE = ArchConfig(
    name="recurrentgemma-9b-smoke",
    family="hybrid",
    n_layers=5,              # 1 period (rec, rec, attn) + tail (rec, rec)
    d_model=64,
    n_heads=4,
    n_kv=1,
    d_ff=128,
    vocab=512,
    head_dim=16,
    act="gelu",
    pattern=(LayerSpec(mixer="rec"), LayerSpec(mixer="rec"),
             LayerSpec(mixer="attn", window=16)),
    rnn_width=64,
    tie_embed=True,
    embed_scale=True,
    kv_chunk=64,
)
