"""Llama-3.2-Vision-90B [hf:meta-llama/Llama-3.2-11B-Vision scaled] — VLM.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; cross-attention
image layers interleaved 1:4 (20 cross + 80 self = 100). The vision encoder
(ViT) + projector is the stubbed frontend: ``input_specs`` provides
precomputed patch embeddings (B, 1600, d_model) — DESIGN.md carve-out.

Port of `src/repro/configs/llama_3_2_vision_90b.py`, the published widths copied
unchanged.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500000.0,
    n_image_tokens=1600,
    period=(
        LayerSpec(kind="cross"),
        LayerSpec(kind="attn"),
        LayerSpec(kind="attn"),
        LayerSpec(kind="attn"),
        LayerSpec(kind="attn"),
    ),
)
