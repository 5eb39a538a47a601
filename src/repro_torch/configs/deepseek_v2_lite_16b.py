"""DeepSeek-V2-Lite (16B) [arXiv:2405.04434] — MoE with MLA.

27L d_model=2048 16H d_ff=1408(per-expert) vocab=102400; MLA kv_lora=512
(no q-lora in Lite); MoE: 2 shared + 64 routed experts, top-6.

Port of `src/repro/configs/deepseek_v2_lite_16b.py`, the published widths copied
unchanged.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,                      # all FFNs are MoE (first-dense simplification
                                 # noted in DESIGN.md §Arch-applicability)
    vocab_size=102400,
    attn_type="mla",
    kv_lora_rank=512,
    rope_head_dim=64,
    n_routed_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1408,
    period=(LayerSpec(kind="attn", moe=True),),
)
