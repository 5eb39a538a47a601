"""MusicGen-medium [arXiv:2306.05284] — decoder-only over EnCodec tokens.

48L d_model=1536 24H d_ff=6144 vocab=2048 per codebook, 4 codebooks with
the delay interleaving pattern. The EnCodec tokenizer (conv codec) is the
stubbed frontend: inputs are codebook token ids (B, S, 4) — DESIGN.md
carve-out.

Port of `src/repro/configs/musicgen_medium.py`, the published widths copied
unchanged.
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    n_codebooks=4,
    period=(LayerSpec(kind="attn"),),
)
