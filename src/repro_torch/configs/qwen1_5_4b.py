"""Qwen1.5-4B [hf:Qwen/Qwen1.5-4B family] — dense GQA with QKV bias.

40L d_model=2560 20H (kv=20, i.e. MHA) d_ff=6912 vocab=151936.

Port of `src/repro/configs/qwen1_5_4b.py`, the published widths copied
unchanged.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    period=(LayerSpec(kind="attn"),),
)
