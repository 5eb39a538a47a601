"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B] — dense, MLA attention.

62L d_model=2560 40H (GQA kv=40) d_ff=6400 vocab=73448; MLA with
kv_lora_rank=256, q_lora_rank=768 per the model card (rope dim 32).

Port of `src/repro/configs/minicpm3_4b.py`, the published widths copied
unchanged.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab_size=73448,
    attn_type="mla",
    kv_lora_rank=256,
    q_lora_rank=768,
    rope_head_dim=32,
    period=(LayerSpec(kind="attn"),),
)
