"""Mamba2-2.7B [arXiv:2405.21060] — attention-free SSD state-space model.

64L d_model=2560 (attn-free), ssm_state=128, expand=2 (d_inner=5120),
head_dim=64 (80 heads), vocab=50280.

Port of `src/repro/configs/mamba2_2_7b.py`, the published widths copied
unchanged.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    ssm_d_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_n_groups=1,
    period=(LayerSpec(kind="mamba"),),
)
