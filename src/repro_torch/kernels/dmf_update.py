"""Fused DMF step kernels (paper Eqs. 9-11): residual, gradients, lr-scaled
u/q deltas, the global-factor message and the batch loss in one pass —
port of `_dmf_fused_step_kernel` / `dmf_fused_step_kernel_call`
(`src/repro/kernels/dmf_update.py:61-89, 165-194`) behind
`ops.dmf_fused_step` (`src/repro/kernels/ops.py:52-73`), and of its DP form
`_dmf_fused_step_dp_kernel` / `dmf_fused_step_dp_kernel_call`
(`dmf_update.py:92-162`) behind `ops.dmf_fused_step_dp` (`ops.py:76-101`),
which also clips each message row to C and adds the row's noise z. Also
the gradients alone, `_dmf_grads_kernel` / `dmf_grads_kernel_call`
(`dmf_update.py:22-58`) behind `ops.dmf_grads` (`ops.py:30-49`).

The TPU wrapper padded B to 256 and K to 128 lanes; the CUDA kernels
(``csrc/dmf_update.cu``) take (B, K) as it is. The step is one launch:
a batch of at most 256 rows is one block, which sums the loss itself; a
larger batch's blocks leave their loss partials and an integer ticket in
a scratch buffer kept per device and stream (zeroed when it is made or
grown, reset by the kernel after each launch), and the last block sums
them in a fixed order. The gradients kernel's launch layout (rows a block)
is chosen here, on the host, by `grads_layout`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref


GRAD_THREADS = 128          # csrc/dmf_update.cu kGradThreads: threads a block, at most its rows
GRAD_ROWS = 32              # rows a block: the fastest of 32/64/128 at both main shapes


def grads_layout(B: int, K: int) -> dict:
    """The launch layout of the gradients kernel for B rows of K factors:
    ``rows`` a block (32: one warp forms the rows' residuals, then the
    block's 128 threads write the 32·K elements; B=256 takes 8 blocks,
    B=2048 64), ``threads`` a block and ``blocks``. K does not change it:
    the rows are read in place, whatever their width."""
    return dict(rows=GRAD_ROWS, threads=GRAD_THREADS, blocks=-(-B // GRAD_ROWS))


def _check_step(name, u, p, q, r, conf, z=None):
    B, K = u.shape
    mats = {"u": u, "p": p, "q": q} if z is None else {"u": u, "p": p, "q": q, "z": z}
    for arg, t in mats.items():
        build.require_shape(name, arg, t, (B, K))
        build.require_dtype(name, arg, t, torch.float32)
    for arg, t in (("r", r), ("conf", conf)):
        build.require_shape(name, arg, t, (B,))
        build.require_dtype(name, arg, t, torch.float32)


# (device index, stream handle) -> the step's scratch: the ticket, which
# each multi-block launch leaves at 0, then the loss partials
_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def _step_scratch(device: torch.device, B: int) -> torch.Tensor | None:
    """The step's scratch for a launch over B rows on the current stream
    of ``device``, or None when B rows are one block."""
    need = build.load().dmf_step_scratch(B)
    if need == 0:
        return None
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < need:
        buf = _SCRATCH[key] = torch.zeros(need, dtype=torch.float32, device=device)
    return buf


def _step_outputs(u):
    """(du, gp, dq, loss, scratch pointer) for one launch on u's device."""
    B = u.shape[0]
    du, gp, dq = (torch.empty_like(u) for _ in range(3))
    if B == 0:   # nothing to launch: the loss of an empty batch is 0
        return du, gp, dq, torch.zeros((), dtype=torch.float32, device=u.device), None
    loss = torch.empty((), dtype=torch.float32, device=u.device)
    scratch = _step_scratch(u.device, B)
    return du, gp, dq, loss, None if scratch is None else scratch.data_ptr()


def dmf_grads(u, p, q, r, conf, *, alpha: float, beta: float, gamma: float):
    """u/p/q: (B, K) f32; r/conf: (B,) f32. Returns (gu, gp, gq), each
    (B, K) f32: the confidence-weighted Eqs. 9-11 gradients, with no
    learning rate and no loss.

    CPU tensors run `ref.dmf_grads_ref`; CUDA tensors launch the kernel
    (and count one in ``dmf_grads.launches``) or raise."""
    name = "dmf_grads"
    _check_step(name, u, p, q, r, conf)
    if not build.on_card(name, u, p, q, r, conf):
        return ref.dmf_grads_ref(u, p, q, r, conf, alpha, beta, gamma)
    build.require_contiguous(name, u=u, p=p, q=q, r=r, conf=conf)
    gu, gp, gq = grads_on_layout(u, p, q, r, conf, alpha, beta, gamma,
                                 grads_layout(*u.shape))
    if u.shape[0]:
        dmf_grads.launches += 1
    return gu, gp, gq


def grads_on_layout(u, p, q, r, conf, alpha: float, beta: float, gamma: float,
                    layout: dict):
    """The gradients kernel on the card with the given layout
    (`grads_layout`'s ``rows``, 1 to 128), the inputs already checked.
    For the public wrapper, and for timing layouts against each other;
    counts no launch."""
    B, K = u.shape
    gu, gp, gq = (torch.empty_like(u) for _ in range(3))
    if B:
        build.launch("dmf_grads", u.device, "dmf_grads_launch",
                     u.data_ptr(), p.data_ptr(), q.data_ptr(), r.data_ptr(), conf.data_ptr(),
                     gu.data_ptr(), gp.data_ptr(), gq.data_ptr(), B, K, alpha, beta, gamma,
                     layout["rows"])
    return gu, gp, gq


def dmf_fused_step(u, p, q, r, conf, *, theta: float, alpha: float,
                   beta: float, gamma: float):
    """u/p/q: (B, K) f32; r/conf: (B,) f32. Returns (du, gp, dq, loss):
    the -θ·grad deltas for u and q, the raw p-gradient message, and the
    0-d batch loss ½·Σ c·raw².

    CPU tensors run `ref.dmf_fused_step_ref`; CUDA tensors launch the
    kernel (and count one in ``dmf_fused_step.launches``) or raise."""
    name = "dmf_fused_step"
    _check_step(name, u, p, q, r, conf)
    if not build.on_card(name, u, p, q, r, conf):
        return ref.dmf_fused_step_ref(u, p, q, r, conf, theta, alpha, beta, gamma)
    build.require_contiguous(name, u=u, p=p, q=q, r=r, conf=conf)
    B, K = u.shape
    du, gp, dq, loss, scratch = _step_outputs(u)
    if B:
        build.launch(name, u.device, "dmf_fused_step_launch",
                     u.data_ptr(), p.data_ptr(), q.data_ptr(), r.data_ptr(), conf.data_ptr(),
                     du.data_ptr(), gp.data_ptr(), dq.data_ptr(), scratch,
                     loss.data_ptr(), B, K, theta, alpha, beta, gamma)
        dmf_fused_step.launches += 1
    return du, gp, dq, loss


def dmf_fused_step_dp(u, p, q, r, conf, z, *, theta: float, alpha: float,
                      beta: float, gamma: float, clip: float):
    """`dmf_fused_step` with the DP mechanism in the same pass: the returned
    gp message is clipped per row to ``clip`` (inf = no clip) and perturbed
    with ``z`` (B, K) f32, the batch's pre-scaled σC noise block.

    CPU tensors run `ref.dmf_fused_step_dp_ref`; CUDA tensors launch the
    kernel (and count one in ``dmf_fused_step_dp.launches``) or raise."""
    name = "dmf_fused_step_dp"
    _check_step(name, u, p, q, r, conf, z)
    if not build.on_card(name, u, p, q, r, conf, z):
        return ref.dmf_fused_step_dp_ref(u, p, q, r, conf, z, theta, alpha, beta, gamma, clip)
    build.require_contiguous(name, u=u, p=p, q=q, r=r, conf=conf, z=z)
    B, K = u.shape
    du, gp, dq, loss, scratch = _step_outputs(u)
    if B:
        build.launch(name, u.device, "dmf_fused_step_dp_launch",
                     u.data_ptr(), p.data_ptr(), q.data_ptr(), r.data_ptr(), conf.data_ptr(),
                     z.data_ptr(), du.data_ptr(), gp.data_ptr(), dq.data_ptr(),
                     scratch, loss.data_ptr(), B, K, theta, alpha, beta, gamma, clip)
        dmf_fused_step_dp.launches += 1
    return du, gp, dq, loss


dmf_grads.launches = 0
dmf_fused_step.launches = 0
dmf_fused_step_dp.launches = 0
