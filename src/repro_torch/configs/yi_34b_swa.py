"""yi-34b-swa — sliding-window variant of yi-34b (window 8192), the
dense-architecture carve-in for long_500k: decode attends to the last 8k
positions via a ring-buffer cache (O(window) memory at 524k context).
Not part of the assigned-10 list; selectable as --arch yi-34b-swa.

Port of `src/repro/configs/yi_34b_swa.py`, the published widths copied
unchanged.
"""
import dataclasses

from repro_torch.configs.yi_34b import CONFIG as _BASE
from repro_torch.models.config import LayerSpec

CONFIG = dataclasses.replace(
    _BASE,
    name="yi-34b-swa",
    period=(LayerSpec(kind="attn", sliding_window=8192),),
)
