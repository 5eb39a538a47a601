"""Mamba2 — SSD (state-space duality) block [arXiv:2405.21060] — port of
`src/repro/models/ssm.py` (all of it: `SSMCache`, `conv_dim`,
`init_mamba` with its logical-axis specs (`MAMBA_SPECS`), `_split_proj`,
`_segsum`, `ssd_chunked`, `mamba_forward`,
`mamba_decode`, `init_ssm_cache`).

Prefill uses the chunked SSD algorithm (quadratic within a chunk, linear
across chunks) in fp32; the cross-chunk recurrence is a Python loop over
the chunks, as the reference's `lax.scan` (:119-133), and also yields the
state before each chunk. Decode is the O(1) recurrent state update.

Shapes: d_inner = expand*d_model, H = d_inner/head_dim (P=head_dim),
state N = ssm_d_state, G = ssm_n_groups (B/C shared per group).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, W-1, conv_dim) rolling conv window
    state: torch.Tensor  # (B, H, P, N) recurrent SSM state


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.ssm_d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_d_state


class Mamba(nn.Module):
    """`init_mamba` (:31-59): ``in_proj`` (d, 2·di + 2·G·N + H) emitting
    [z, x, B, C, dt]; ``conv_w`` (W, conv_dim) at 0.02 and zero ``conv_b``;
    ``A_log`` = log(linspace(1, 16, H)) (A = -exp(A_log)); ``D`` ones;
    ``dt_bias`` = softplus⁻¹(0.01); ``norm`` ones (di,); ``out_proj`` (di, d)
    at 0.02/sqrt(2·n_layers)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        d, di = cfg.d_model, cfg.ssm_d_inner
        H, N, G = cfg.ssm_n_heads, cfg.ssm_d_state, cfg.ssm_n_groups
        cdim = conv_dim(cfg)
        s, so = 0.02, 0.02 / math.sqrt(2 * cfg.n_layers)
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = layers.normal((d, 2 * di + 2 * G * N + H), s, generator, device)
        self.conv_w = layers.normal((cfg.ssm_conv_width, cdim), s, generator, device)
        self.conv_b = nn.Parameter(torch.zeros((cdim,), **f32))
        # the constants on the host, then moved (on the meta device these
        # ops would first import PyTorch's decompositions, seconds)
        A_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32))
        dt_bias = torch.log(torch.expm1(torch.full((H,), 1e-2, dtype=torch.float32)))
        self.A_log = nn.Parameter(A_log.to(device))
        self.D = nn.Parameter(torch.ones((H,), **f32))
        self.dt_bias = nn.Parameter(dt_bias.to(device))
        self.norm = layers.init_rms_norm(di, device)
        self.out_proj = layers.normal((di, d), so, generator, device)


MAMBA_SPECS = {   # the logical axes `init_mamba` returns (:49-58)
    "in_proj": ("embed", "ssm_inner"), "conv_w": (None, "ssm_inner"), "conv_b": ("ssm_inner",),
    "A_log": ("ssm_heads",), "D": ("ssm_heads",), "dt_bias": ("ssm_heads",),
    "norm": ("ssm_inner",), "out_proj": ("ssm_inner", "embed"),
}


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, G, N = cfg.ssm_d_inner, cfg.ssm_n_groups, cfg.ssm_d_state
    sizes = [di, di, G * N, G * N, zxbcdt.shape[-1] - 2 * di - 2 * G * N]
    z, x, Bc, Cc, dt = torch.split(zxbcdt, sizes, dim=-1)
    return z, x, Bc, Cc, dt


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Segment sum of the 1-SS matrix: L[..., i, j] = sum_{j<k<=i} x[k];
    -inf above the diagonal, so that exp gives exact zeros there."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device), 0)
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(
    x: torch.Tensor,     # (B, L, H, P)
    dt: torch.Tensor,    # (B, L, H)  (post-softplus)
    A: torch.Tensor,     # (H,) negative
    Bm: torch.Tensor,    # (B, L, G, N)
    Cm: torch.Tensor,    # (B, L, G, N)
    chunk: int,
    init_state: torch.Tensor | None = None,   # (B, H, P, N)
):
    """Chunked SSD scan in fp32. Returns (y (B,L,H,P), final_state (B,H,P,N))."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    assert L % chunk == 0, (L, chunk)
    nc = L // chunk
    rep = H // G

    xb = x.reshape(Bsz, nc, chunk, H, P).float()
    dtb = dt.reshape(Bsz, nc, chunk, H).float()
    Bb = Bm.reshape(Bsz, nc, chunk, G, N).float()
    Cb = Cm.reshape(Bsz, nc, chunk, G, N).float()
    dA = dtb * A.float()                                      # (B,nc,c,H)

    dA_cs = torch.cumsum(dA, dim=2)                           # within-chunk cumsum
    # 1) intra-chunk (diagonal blocks): y = (C B^T ∘ L) x with decay matrix L
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))         # (B,nc,H,c,c)
    CB = torch.einsum("bkcgn,bksgn->bkgcs", Cb, Bb)           # (B,nc,G,c,s)
    CB = torch.repeat_interleave(CB, rep, dim=2)              # -> (B,nc,H,c,s)
    att = CB * Lmat * dtb.permute(0, 1, 3, 2)[..., None, :]   # × dt_s
    y_diag = torch.einsum("bkhcs,bkshp->bkchp", att, xb)

    # 2) per-chunk final states: S_n = sum_s exp(dA_cs[c_end]-dA_cs[s]) dt_s B_s x_s
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)     # (B,nc,c,H)
    sB = torch.repeat_interleave(Bb, rep, dim=3)              # (B,nc,c,H,N)
    states = torch.einsum("bkch,bkchn,bkchp->bkhpn", decay_states * dtb, sB, xb)

    # 3) inter-chunk recurrence over chunk states (the reference's scan)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])               # (B,nc,H)
    s_prev = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
              if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(s_prev)
        s_prev = s_prev * chunk_decay[:, c, :, None, None] + states[:, c]
    final_state = s_prev
    prev_states = torch.stack(prev, dim=1)                    # (B,nc,H,P,N)

    # 4) off-diagonal contribution from the carried state
    state_decay = torch.exp(dA_cs)                            # (B,nc,c,H)
    sC = torch.repeat_interleave(Cb, rep, dim=3)              # (B,nc,c,H,N)
    y_off = torch.einsum("bkchn,bkhpn,bkch->bkchp", sC, prev_states, state_decay)

    y = (y_diag + y_off).reshape(Bsz, L, H, P)
    return y, final_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: logaddexp(x, 0), with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba_forward(params: Mamba, x: torch.Tensor, cfg: ModelConfig, dtype
                  ) -> tuple[torch.Tensor, SSMCache]:
    """Full-sequence Mamba2 block (prefill). Returns the output and the
    decode cache (conv tail, left-padded when L < W-1, + final SSM state)."""
    B, L, _ = x.shape
    H, P, N, G = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_d_state, cfg.ssm_n_groups
    di, W = cfg.ssm_d_inner, cfg.ssm_conv_width
    zxbcdt = torch.einsum("bld,de->ble", x, params.in_proj.to(dtype))
    z, xr, Bc, Cc, dt = _split_proj(cfg, zxbcdt)

    conv_in = torch.cat([xr, Bc, Cc], dim=-1)                # (B, L, cdim)
    conv_tail = conv_in[:, max(L - (W - 1), 0):, :]
    if conv_tail.shape[1] < W - 1:   # L < W-1 (tiny shapes)
        conv_tail = F.pad(conv_tail, (0, 0, W - 1 - conv_tail.shape[1], 0))
    # causal depthwise conv1d
    pad = F.pad(conv_in, (0, 0, W - 1, 0))
    conv = sum(pad[:, i:i + L, :] * params.conv_w[i].to(dtype) for i in range(W)) \
        + params.conv_b.to(dtype)
    conv = F.silu(conv)
    xr, Bc, Cc = torch.split(conv, [di, G * N, G * N], dim=-1)

    dt = softplus(dt.float() + params.dt_bias.float())
    A = -torch.exp(params.A_log.float())
    y, state = ssd_chunked(
        xr.reshape(B, L, H, P), dt, A,
        Bc.reshape(B, L, G, N), Cc.reshape(B, L, G, N),
        chunk=min(cfg.ssm_chunk, L),
    )
    y = y + params.D.float()[None, None, :, None] * xr.reshape(B, L, H, P).float()
    y = y.reshape(B, L, di).to(dtype)
    y = layers.rms_norm(y * F.silu(z), params.norm, cfg.norm_eps)
    out = torch.einsum("ble,ed->bld", y, params.out_proj.to(dtype))
    return out, SSMCache(conv=conv_tail.to(dtype), state=state.float())


def mamba_decode(params: Mamba, x: torch.Tensor, cache: SSMCache, cfg: ModelConfig, dtype
                 ) -> tuple[torch.Tensor, SSMCache]:
    """One-token recurrent update: state' = state*exp(dt A) + dt B ⊗ x; the
    conv window shifts by one (:215)."""
    B = x.shape[0]
    H, P, N, G = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_d_state, cfg.ssm_n_groups
    di = cfg.ssm_d_inner
    zxbcdt = torch.einsum("bd,de->be", x[:, 0], params.in_proj.to(dtype))
    z, xr, Bc, Cc, dt = _split_proj(cfg, zxbcdt)

    conv_in = torch.cat([xr, Bc, Cc], dim=-1)                # (B, cdim)
    win = torch.cat([cache.conv, conv_in[:, None, :]], dim=1)  # (B, W, cdim)
    conv = torch.einsum("bwc,wc->bc", win, params.conv_w.to(dtype)) + params.conv_b.to(dtype)
    conv = F.silu(conv)
    xr, Bc, Cc = torch.split(conv, [di, G * N, G * N], dim=-1)

    dt = softplus(dt.float() + params.dt_bias.float())       # (B,H)
    A = -torch.exp(params.A_log.float())
    decay = torch.exp(dt * A)                                 # (B,H)
    xh = xr.reshape(B, H, P).float()
    rep = H // G
    Bh = torch.repeat_interleave(Bc.reshape(B, G, N), rep, dim=1).float()
    Ch = torch.repeat_interleave(Cc.reshape(B, G, N), rep, dim=1).float()
    state = cache.state * decay[..., None, None] + torch.einsum("bh,bhp,bhn->bhpn", dt, xh, Bh)
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    y = y + params.D.float()[None, :, None] * xh
    y = y.reshape(B, di).to(dtype)
    y = layers.rms_norm(y * F.silu(z), params.norm, cfg.norm_eps)
    out = torch.einsum("be,ed->bd", y, params.out_proj.to(dtype))
    return out[:, None, :], SSMCache(conv=win[:, 1:, :], state=state)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> SSMCache:
    H, P, N = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_d_state
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim(cfg)), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
    )
