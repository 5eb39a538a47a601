"""Yi-34B [arXiv:2403.04652] — llama-architecture dense GQA.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

Port of `src/repro/configs/yi_34b.py`, the published widths copied
unchanged.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5000000.0,
    period=(LayerSpec(kind="attn"),),
)
