"""Common layers: RMSNorm, RoPE, dense (SwiGLU) MLP, embeddings — port of
`src/repro/models/layers.py:14-78` (`rms_norm`, `init_rms_norm`,
`rope_freqs`, `apply_rope`, `init_mlp`/`mlp`, `init_embedding`,
`init_lm_head`). `chunked_cross_entropy` (:80) belongs to training.

Parameters keep the reference's layouts (MLP weights ``(d, F)`` and
``(F, d)``, the embedding ``(vocab, d)``, the head ``(d, vocab)``) and are
float32; each product casts its weight to the compute dtype at the point
of use, as the reference's ``.astype(dtype)`` does.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def init_rms_norm(d: int, device=None) -> nn.Parameter:
    return nn.Parameter(torch.ones((d,), dtype=torch.float32, device=device))


# --- RoPE -------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """float64 on the host, as the reference computes it (cast at use)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


@functools.cache
def _rope_table(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """`rope_freqs` as fp32 on ``device``, made once: a copy from pageable
    host memory a call would wait for the card's queue to drain."""
    with torch.inference_mode(False):
        return torch.as_tensor(rope_freqs(head_dim, theta).astype(np.float32), device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), the split-halves form (`layers.py:36-38`);
    positions broadcastable to (..., S). Angles in fp32."""
    hd = x.shape[-1]
    freqs = _rope_table(hd, float(theta), x.device)
    ang = positions[..., None].float() * freqs                      # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def normal(shape, std: float, generator: torch.Generator | None, device) -> nn.Parameter:
    """A float32 parameter drawn N(0, std²) from ``generator``; without a
    generator it is left uninitialised (shapes on the meta device, or
    storage that the carry-over fills)."""
    if generator is None:
        return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))
    t = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return nn.Parameter(t.mul_(std))


# --- dense (SwiGLU) MLP -----------------------------------------------------
class MLP(nn.Module):
    """`init_mlp` (`layers.py:44-57`): ``wi``, ``wg`` (d, F), ``wo`` (F, d),
    all at 0.02."""

    def __init__(self, d_model: int, d_ff: int, *, generator=None, device=None):
        super().__init__()
        s = 0.02
        self.wi = normal((d_model, d_ff), s, generator, device)
        self.wg = normal((d_model, d_ff), s, generator, device)
        self.wo = normal((d_ff, d_model), s, generator, device)


def mlp(params: MLP, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    h = torch.einsum("...d,df->...f", x, params.wi.to(dtype))
    g = torch.einsum("...d,df->...f", x, params.wg.to(dtype))
    h = F.silu(g) * h
    return torch.einsum("...f,fd->...d", h, params.wo.to(dtype))


# --- embeddings / unembedding ----------------------------------------------
def init_embedding(vocab: int, d_model: int, *, generator=None, device=None) -> nn.Parameter:
    return normal((vocab, d_model), 0.02, generator, device)


def init_lm_head(d_model: int, vocab: int, *, generator=None, device=None) -> nn.Parameter:
    return normal((d_model, vocab), 0.02, generator, device)
