"""granite-moe-3b-a800m [moe] -- 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8 [hf:ibm-granite/granite-3.0-*-base].

Note: the brief's prose says "32 experts top-8" while the structured field
says "MoE 40e top-8"; we follow the structured field (40) and record the
discrepancy here.  Sharding: 40 experts do not divide the 16-way model
axis, so this arch overrides the MoE rules to TP *inside* each expert
(``expert_mlp`` -> model, 512/16 = 32 cols/device) instead of replicating
40 expert stacks.
"""
from repro_torch.models.transformer import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    act="silu",
    pattern=(LayerSpec(mixer="attn", moe=True),),
    num_experts=40,
    top_k=8,
    tie_embed=True,
    rope_theta=10000.0,
    rules={"expert": None, "expert_mlp": "model"},
)

SMOKE = ArchConfig(
    name="granite-moe-3b-a800m-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=2,
    d_ff=32,
    vocab=512,
    head_dim=16,
    act="silu",
    pattern=(LayerSpec(mixer="attn", moe=True),),
    num_experts=8,
    top_k=2,
    tie_embed=True,
    kv_chunk=64,
)
