"""Jamba-1.5-Large (398B) [arXiv:2403.19887] — hybrid Mamba+attention MoE.

72L d_model=8192 64H (GQA kv=8) d_ff=24576; Mamba:attn 7:1 interleave
(period of 8 with one attention layer), MoE 16 experts top-2 on every
other layer; vocab=65536.

Port of `src/repro/configs/jamba_1_5_large_398b.py`, the published widths copied
unchanged.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

_M = LayerSpec(kind="mamba")
_Mmoe = LayerSpec(kind="mamba", moe=True)
_A = LayerSpec(kind="attn")
_Amoe = LayerSpec(kind="attn", moe=True)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    n_routed_experts=16,
    n_shared_experts=0,
    moe_top_k=2,
    moe_d_ff=24576,
    ssm_d_state=128,
    ssm_expand=2,
    ssm_head_dim=128,
    ssm_n_groups=8,
    # period of 8: [M, Mmoe, M, Mmoe, A, Mmoe, M, Mmoe] — 1 attn : 7 mamba,
    # MoE every other layer (Jamba's documented 1:7 / alternate-MoE layout)
    period=(_M, _Mmoe, _M, _Mmoe, _A, _Mmoe, _M, _Mmoe),
)
