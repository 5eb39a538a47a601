"""Common layers: RMSNorm, RoPE, dense (SwiGLU) MLP, embeddings — port of
`src/repro/models/layers.py:14-78` (`rms_norm`, `init_rms_norm`,
`rope_freqs`, `apply_rope`, `init_mlp`/`mlp`, `init_embedding`,
`init_lm_head`, with the logical-axis specs they return) and
`chunked_cross_entropy` (:80-114).

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
import torch.utils.checkpoint
from torch import nn


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def init_rms_norm(d: int, device=None) -> nn.Parameter:
    return nn.Parameter(torch.ones((d,), dtype=torch.float32, device=device))


RMS_NORM_SPEC = ("embed_nodiv",)      # `init_rms_norm`'s logical axes (:21-22)


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


MLP_SPECS = {"wi": ("embed", "ff"), "wg": ("embed", "ff"), "wo": ("ff", "embed")}   # :52-56


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


EMBEDDING_SPEC = ("vocab", "embed_nodiv")     # `init_embedding`'s logical axes (:67-70)
LM_HEAD_SPEC = ("embed_nodiv", "vocab")       # `init_lm_head`'s (:73-77)


def _chunk_ce(hc: torch.Tensor, lm_head: torch.Tensor, lc: torch.Tensor):
    """(sum of the chunk's token losses, its count of labels >= 0)."""
    logits = torch.einsum("bsd,dv->bsv", hc, lm_head).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(lc, min=0).long()[..., None])[..., 0]
    mask = (lc >= 0).float()
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def chunked_cross_entropy(
    h: torch.Tensor,            # (B, S, D) final hidden states
    lm_head: torch.Tensor,      # (D, V)
    labels: torch.Tensor,       # (B, S) int, -1 = ignore
    chunk: int = 1024,
    *,
    remat: bool = False,
    n_labels: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean CE, computing logits chunk-by-chunk over the sequence so the
    (B, S, V) logits tensor is never materialized (memory-roofline relevant
    for 128k-256k vocabularies): ``S // chunk`` chunks, then the remainder
    as one chunk of its own, as the reference's scan and tail do.

    With ``remat`` (``cfg.remat``) and grad enabled, each chunk runs under
    `torch.utils.checkpoint.checkpoint` (non-reentrant): its logits are
    freed after the forward and recomputed in the backward, so the
    backward never holds more than one chunk's (B, chunk, V) logits either
    (at vocab 151,936 one sequence of 4,096 tokens is 2.5 GB of fp32
    logits).

    ``n_labels``: the count of labels >= 0 to divide the sum by, in place
    of these labels' own: a rank's share of a batch split over ranks
    divides by the whole batch's count, so that the ranks' shares sum to
    its mean however the ignored labels fall."""
    B, S, D = h.shape
    chunk = min(chunk, S)
    n = S // chunk
    rem = S - n * chunk
    ckpt = remat and torch.is_grad_enabled()

    def one(hc, lc):
        if ckpt:
            return torch.utils.checkpoint.checkpoint(_chunk_ce, hc, lm_head, lc,
                                                     use_reentrant=False)
        return _chunk_ce(hc, lm_head, lc)

    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n):
        l, m = one(h[:, i * chunk:(i + 1) * chunk], labels[:, i * chunk:(i + 1) * chunk])
        tot, cnt = tot + l, cnt + m
    if rem:
        l, m = one(h[:, n * chunk:], labels[:, n * chunk:])
        tot, cnt = tot + l, cnt + m
    return tot / torch.clamp(cnt if n_labels is None else n_labels, min=1.0)
