"""llama4-scout-17b-a16e [moe] -- 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 16 experts top-1 + shared expert, early
fusion [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Layer pattern follows llama4's interleaved attention: 3 chunked-local
(window 8192, RoPE) layers then 1 global NoPE layer, all layers MoE with a
shared expert (Scout routes top-1).

Sharding note: 40 query heads do not divide the 16-way model axis; the
baseline falls back to replicated attention weights (params kept bf16 for
this arch to bound the replicated bytes) -- a recorded hillclimb candidate
(EXPERIMENTS.md section Perf).
"""
import torch

from repro_torch.models.transformer import ArchConfig, LayerSpec

_LOCAL = LayerSpec(mixer="attn", window=8192, rope=True, moe=True)
_GLOBAL = LayerSpec(mixer="attn", window=None, rope=False, moe=True)

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    act="silu",
    pattern=(_LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    num_experts=16,
    top_k=1,
    shared_expert_ff=8192,
    tie_embed=False,
    rope_theta=500000.0,
    param_dtype=torch.bfloat16,
)

SMOKE = ArchConfig(
    name="llama4-scout-17b-a16e-smoke",
    family="moe",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=64,
    vocab=512,
    head_dim=16,
    act="silu",
    pattern=(LayerSpec(mixer="attn", window=16, rope=True, moe=True),
             LayerSpec(mixer="attn", window=None, rope=False, moe=True)),
    num_experts=4,
    top_k=1,
    shared_expert_ff=64,
    capacity_factor=4.0,  # smoke: avoid routing drops in consistency tests
    tie_embed=False,
    kv_chunk=64,
)
