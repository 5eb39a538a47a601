"""The DP mechanism's counter-keyed Gaussian stream and the fused per-row
clip + noise kernel — port of `src/repro/kernels/dp_noise.py`
(`KMAX`, `_mix32`, `gauss_counter` :46-83, `_dp_clip_noise_kernel` :98-138)
behind `ops.dp_clip_noise` (`src/repro/kernels/ops.py:104-127`).

The stream is a spec, not "a Gaussian": the draw for message row ``rid``,
column ``k`` is a pure function of ``(seed, rid, k)``. Counters
``(rid mod 2^23)·2·KMAX + 2k`` and ``+1`` feed the lowbias32 hash, the high
rid bits fold into a per-row key, and two 24-bit uniforms Box-Muller into
one standard normal. The CUDA definition is ``csrc/dp_noise.cu``; the plain
versions here reproduce it, and the reference, hash word for hash word.
The stream kernel draws two columns of one row a thread, in blocks of
whole rows (`stream_layout`), as many blocks as cover the rows.

CPU PyTorch has no uint32 ``>>``, so the plain hash runs in int64 with
every product and sum masked to 32 bits; a product by a 32-bit constant is
split at 16 bits so that no int64 intermediate overflows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

KMAX = 256                 # max factor dim the counter layout supports
_STRIDE = 2 * KMAX         # counters per message row
_MASK = 0xFFFFFFFF
_M1, _M2, _GOLDEN = 0x21F0AAAD, 0x735A2D97, 0x9E3779B9
_TWO_PI_F32 = 6.2831855    # rounds to fp32(2π), the reference's fp32 product


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """Low-bias 32-bit avalanche hash on int64 tensors holding uint32."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 15)


def counter_words_ref(seed: int, rid: torch.Tensor, n_cols: int):
    """The two hash words (h1, h2) behind every draw, as (N, n_cols) int64
    holding uint32: the plain version of the stream's integer half."""
    r = rid.reshape(-1, 1).to(torch.int64) & _MASK
    s = _mix32(torch.tensor(int(seed) & _MASK, dtype=torch.int64, device=rid.device))
    col = torch.arange(n_cols, dtype=torch.int64, device=rid.device)[None, :]
    s_row = _mix32(s ^ ((_mul32(r >> 23, _GOLDEN) + 1) & _MASK))
    base = ((r & 0x7FFFFF) * _STRIDE + col * 2) & _MASK
    h1 = _mix32(base ^ s_row)
    h2 = _mix32(((base + 1) & _MASK) ^ _mul32(s_row, _GOLDEN))
    return h1, h2


def gauss_counter_ref(seed: int, rid: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Plain version of the stream: (N, n_cols) f32 ~ N(0, 1) for the N
    rids of ``rid`` (int32, any shape)."""
    h1, h2 = counter_words_ref(seed, rid, n_cols)
    u1 = ((h1 >> 8) + 1).to(torch.float32) * 2.0**-24   # (0, 1]: log finite
    u2 = (h2 >> 8).to(torch.float32) * 2.0**-24         # [0, 1)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI_F32 * u2)


def _check_stream(name: str, rid: torch.Tensor, n_cols: int) -> torch.Tensor:
    build.require_dtype(name, "rid", rid, torch.int32)
    if not 0 < n_cols <= KMAX:
        raise ValueError(f"{name}: n_cols={n_cols} outside 1..{KMAX}")
    return rid.reshape(-1)


STREAM_THREADS = 128        # threads a stream block holds at most (one row may need more)


def stream_layout(n_cols: int) -> dict:
    """The stream kernel's block for rows of n_cols: ``per`` columns a
    thread (2 for even n_cols, else 1) and ``rows`` whole rows a block
    (n_cols / per threads a row, at most 128 threads unless one row needs
    more). The kernel launches ceil(N / rows) blocks."""
    per = 2 if n_cols % 2 == 0 else 1
    x = n_cols // per
    rows = max(1, STREAM_THREADS // x)
    return dict(per=per, rows=rows, threads=x * rows)


def _stream(name: str, fn: str, rid: torch.Tensor, outs: tuple, n_cols: int, seed: int) -> None:
    """Launch the stream kernel ``fn`` over rid's N rows into ``outs``."""
    lay = stream_layout(n_cols)
    build.launch(name, rid.device, fn, rid.data_ptr(), *(o.data_ptr() for o in outs),
                 rid.shape[0], n_cols, int(seed) & _MASK, lay["per"], lay["rows"])


def gauss_counter(seed: int, rid: torch.Tensor, n_cols: int) -> torch.Tensor:
    """(N, n_cols) f32 standard-normal draws, a pure function of (seed,
    rid, column); ``rid`` int32 of N global message-row ids.

    CPU tensors run `gauss_counter_ref`; CUDA tensors launch the kernel (and
    count one in ``gauss_counter.launches``) or raise."""
    name = "gauss_counter"
    rid = _check_stream(name, rid, n_cols)
    if not build.on_card(name, rid):
        return gauss_counter_ref(seed, rid, n_cols)
    build.require_contiguous(name, rid=rid)
    N = rid.shape[0]
    out = torch.empty((N, n_cols), dtype=torch.float32, device=rid.device)
    if N:
        _stream(name, "gauss_counter_launch", rid, (out,), n_cols, seed)
        gauss_counter.launches += 1
    return out


def counter_words(seed: int, rid: torch.Tensor, n_cols: int):
    """The kernel's hash words (h1, h2), (N, n_cols) int64 holding uint32 —
    a check hook that holds the CUDA stream against `counter_words_ref`
    word for word. CPU tensors run `counter_words_ref`."""
    name = "counter_words"
    rid = _check_stream(name, rid, n_cols)
    if not build.on_card(name, rid):
        return counter_words_ref(seed, rid, n_cols)
    build.require_contiguous(name, rid=rid)
    N = rid.shape[0]
    h1, h2 = (torch.empty((N, n_cols), dtype=torch.int32, device=rid.device)
              for _ in range(2))
    if N:
        _stream(name, "counter_words_launch", rid, (h1, h2), n_cols, seed)
    return tuple(h.to(torch.int64) & _MASK for h in (h1, h2))


def dp_clip_noise(g: torch.Tensor, rid: torch.Tensor, seed: int, *, clip: float,
                  noise_std: float) -> torch.Tensor:
    """Fused DP mechanism over a block of gradient messages: per-row L2
    clip to ``clip`` plus ``noise_std`` times the counter-keyed draws of the
    rows' ``rid``. g: (B, K) f32; rid: (B,) int32; seed: int. ``clip=inf``
    scales by exactly 1 and ``noise_std=0`` skips the add, so the disabled
    mechanism returns g bit for bit.

    CPU tensors run `ref.dp_clip_noise_ref`; CUDA tensors launch the kernel
    (and count one in ``dp_clip_noise.launches``) or raise."""
    name = "dp_clip_noise"
    B, K = g.shape
    build.require_dtype(name, "g", g, torch.float32)
    rid = _check_stream(name, rid, K)
    build.require_shape(name, "rid", rid, (B,))
    if not build.on_card(name, g, rid):
        return ref.dp_clip_noise_ref(g, rid, seed, clip, noise_std)
    build.require_contiguous(name, g=g, rid=rid)
    out = torch.empty_like(g)
    if B:
        build.launch(name, g.device, "dp_clip_noise_launch", g.data_ptr(), rid.data_ptr(),
                     out.data_ptr(), B, K, int(seed) & _MASK, clip, noise_std)
        dp_clip_noise.launches += 1
    return out


gauss_counter.launches = 0
dp_clip_noise.launches = 0
