"""mamba2-780m [ssm] -- 48L d_model=1536 attention-free, ssm_state=128,
vocab=50280; SSD (state-space duality) [arXiv:2405.21060].

Blocks are pure Mamba-2 mixers (no separate MLP; d_ff=0 per the brief).
Decode state is O(1) per layer -> runs long_500k.
"""
from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,     # unused by the ssm mixer
    n_kv=1,
    d_ff=0,
    vocab=50280,
    head_dim=64,
    pattern=(LayerSpec(mixer="ssm", mlp=False),),
    ssm_state=128,
    ssm_headdim=64,
    tie_embed=True,
)

SMOKE = ArchConfig(
    name="mamba2-780m-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=1,
    n_kv=1,
    d_ff=0,
    vocab=512,
    head_dim=16,
    pattern=(LayerSpec(mixer="ssm", mlp=False),),
    ssm_state=16,
    ssm_headdim=16,
    tie_embed=True,
    ssd_chunk=32,
)
