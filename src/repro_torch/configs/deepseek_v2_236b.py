"""DeepSeek-V2 (236B) [arXiv:2405.04434] — MoE with MLA.

60L d_model=5120 128H d_ff=1536(per-expert) vocab=102400; MLA kv_lora=512,
q_lora=1536; MoE: 2 shared + 160 routed experts, top-6.

Port of `src/repro/configs/deepseek_v2_236b.py`, the published widths copied
unchanged.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=0,
    vocab_size=102400,
    attn_type="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    n_routed_experts=160,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1536,
    period=(LayerSpec(kind="attn", moe=True),),
)
