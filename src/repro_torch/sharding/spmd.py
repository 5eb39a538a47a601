"""One rank's program on a mesh: the collectives over mesh axes, their
autograd counterparts, and the gathering of DTensor-stored parameters —
the port's counterpart of what the reference's `shard_map` bodies and
XLA's SPMD partitioner do (`lax.psum`, `lax.pmean`, `lax.all_gather`,
`axis_index`; the FSDP all-gathers and gradient reduce-scatters XLA
inserts around `rules.params_pspecs`-sharded weights).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with the
reference's axis names. A collective over several axes is composed of
one-axis collectives on the mesh's sub-groups, in mesh order (an
all-gather over ``("pod", "data")`` lays blocks out pod-major, as jax's
``tiled=True`` gather over a tuple of axes does). Under gloo a CUDA
tensor is staged through the host: gloo's own CUDA paths abort on some
collectives on one card (seen on an H100 host), so every collective here runs
on a host copy there. `timed(clock)` charges each collective's wall time,
between two device synchronisations, to an `ExchangeClock`.

Parameters are stored as DTensors with the placements `rules` resolves
(`rules.placements`). `gather` makes a plain tensor of one for compute —
the counterpart of ``redistribute(Replicate()).to_local(grad_placements=…)``,
written out so that it runs on the staged collectives — all-gathering
each sharded dim (inner mesh dims first) and, in the backward, reducing
the gradient back onto the stored shard: a reduce-scatter where the
gradient is partial over a mesh dim (each batch shard's own tokens), the
rank's slice where it is replicated (the model-axis ranks of one batch
shard compute the dense layers redundantly).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import torch
import torch.distributed as dist

# torch >= 2.13 names the flat collectives `*_single` (2.11 has only the older names)
_all_gather_flat = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)

_CLOCK: list = [None]


@contextlib.contextmanager
def timed(clock):
    """Charge every collective of this module to ``clock`` (an
    `ExchangeClock`) inside the block."""
    prev, _CLOCK[0] = _CLOCK[0], clock
    try:
        yield clock
    finally:
        _CLOCK[0] = prev


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


_PINNED: dict = {}


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """``x`` copied into a pinned host buffer kept for its size (a copy
    from the card into pageable memory runs ~10x slower); the buffer is
    free again once the collective that reads it returns."""
    key = (x.numel(), x.dtype)
    buf = _PINNED.get(key)
    if buf is None:
        buf = _PINNED[key] = torch.empty(x.numel(), dtype=x.dtype, pin_memory=True)
    buf.copy_(x.reshape(-1))
    return buf.view(x.shape)


def release_staging() -> None:
    """Free the pinned staging buffers."""
    _PINNED.clear()


def _run(op, x: torch.Tensor, group):
    """``op(host_or_device_tensor)`` under the clock; ``x`` staged through
    the host under gloo. Returns op's result on x's device."""
    clock = _CLOCK[0]
    if clock is not None and x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    if _staged(x, group):
        out = op(_to_host(x)).to(x.device)
    else:
        out = op(x)
    if clock is not None:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        clock.seconds += time.perf_counter() - t0
        clock.calls += 1
    return out


def axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, axes) -> int:
    return math.prod(mesh.size(axis_names(mesh).index(a)) for a in axes)


def coordinate(mesh, axes) -> int:
    """This rank's linear index over ``axes`` (mesh order, the first major)."""
    idx = 0
    for a in axes:
        idx = idx * mesh.size(axis_names(mesh).index(a)) + mesh.get_local_rank(a)
    return idx


def _group(mesh, axis):
    return mesh.get_group(axis)


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``x`` reduced (sum or max) over ``axes``."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    out = x.clone()
    for a in axes:
        if axis_size(mesh, (a,)) == 1:
            continue
        g = _group(mesh, a)

        def one(t, g=g):
            t = t.contiguous()
            dist.all_reduce(t, op=red, group=g)
            return t
        out = _run(one, out, g)
    return out


def all_gather(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """``x`` of every rank over ``axes`` concatenated along ``dim``, in
    linear order over ``axes``; contiguous, so that a gathered weight has
    the one-device weight's layout (on the card a transposed layout takes
    other cuBLAS algorithms, whose sums round otherwise)."""
    for a in reversed(tuple(axes)):
        n = axis_size(mesh, (a,))
        if n == 1:
            continue
        g = _group(mesh, a)

        def one(t, g=g, n=n):
            out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
            _all_gather_flat(out, t, group=g)
            return out
        x = _run(one, x.movedim(dim, 0).contiguous(), g).movedim(0, dim).contiguous()
    return x


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """``x`` summed over ``axes``; this rank keeps its block of ``dim``
    (blocks in linear order over ``axes``). A CUDA tensor staged through
    the host under gloo is all-reduced and sliced (there gloo's
    reduce-scatter takes ~3x its all-reduce); every other tensor, the
    CPU tests' under gloo as nccl's, goes through the reduce-scatter."""
    for a in tuple(axes):
        n = axis_size(mesh, (a,))
        if n == 1:
            continue
        g = _group(mesh, a)
        staged = _staged(x, g)

        def one(t, g=g, n=n, a=a, staged=staged):
            if staged:
                dist.all_reduce(t, group=g)
                size = t.shape[0] // n
                return t[mesh.get_local_rank(a) * size:][:size].clone()
            out = torch.empty((t.shape[0] // n, *t.shape[1:]), dtype=t.dtype, device=t.device)
            _reduce_scatter_flat(out, t, group=g)
            return out
        x = _run(one, x.movedim(dim, 0).contiguous(), g).movedim(0, dim)
    return x


def local_block(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``dim`` over ``axes`` (no communication)."""
    n = axis_size(mesh, axes)
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, coordinate(mesh, axes) * size, size)


def ring_neighbours(x: torch.Tensor, mesh, axis: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(``x`` of the previous rank on ``axis``, ``x`` of the next), ring
    order: ``torch.roll(stack, 1)`` and ``roll(stack, -1)`` at this rank."""
    n = axis_size(mesh, (axis,))
    if n == 1:
        return x, x
    g = _group(mesh, axis)
    ranks = dist.get_process_group_ranks(g)
    me = mesh.get_local_rank(axis)
    prv, nxt = ranks[(me - 1) % n], ranks[(me + 1) % n]

    def one(t):
        t = t.contiguous()
        a = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, nxt, group=g), dist.P2POp(dist.irecv, a, prv, group=g)]
        if n > 2:       # two learners: one neighbour on both sides, one exchange
            b = torch.empty_like(t)
            ops += [dist.P2POp(dist.isend, t, prv, group=g), dist.P2POp(dist.irecv, b, nxt, group=g)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return torch.stack([a, b]) if n > 2 else a[None]
    both = _run(one, x, g)
    return both[0], both[-1]


# ---------------------------------------------------------------------------
# autograd: the region ops (forward / backward pairs)
# ---------------------------------------------------------------------------
class _SumFwd(torch.autograd.Function):
    """Forward: sum over ``axes``. Backward: identity (what follows is
    computed redundantly over ``axes``, so each rank's gradient is whole)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumBwd(torch.autograd.Function):
    """Forward: identity. Backward: sum over ``axes`` (each rank's use is
    one part of the gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _MeanOver(torch.autograd.Function):
    """``lax.pmean``: forward the mean over ``axes``; backward the mean of
    the ranks' gradient parts."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes, ctx.n = mesh, axes, axis_size(mesh, axes)
        return all_reduce(x, mesh, axes) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes) / ctx.n, None, None


class _GatherFwd(torch.autograd.Function):
    """Forward: all-gather over ``axes`` along dim 0. Backward: reduce-scatter."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_gather(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, ctx.axes), None, None


class _ScatterFwd(torch.autograd.Function):
    """Forward: reduce-scatter over ``axes`` along dim 0. Backward: all-gather."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return reduce_scatter(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axes), None, None


class _GradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s: float):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def sum_fwd(x, mesh, axes):
    return _SumFwd.apply(x, mesh, tuple(axes)) if axis_size(mesh, axes) > 1 else x


def sum_bwd(x, mesh, axes):
    return _SumBwd.apply(x, mesh, tuple(axes)) if axis_size(mesh, axes) > 1 else x


def mean_over(x, mesh, axes):
    return _MeanOver.apply(x, mesh, tuple(axes)) if axis_size(mesh, axes) > 1 else x


def gather_fwd(x, mesh, axes):
    return _GatherFwd.apply(x, mesh, tuple(axes)) if axis_size(mesh, axes) > 1 else x


def scatter_fwd(x, mesh, axes):
    return _ScatterFwd.apply(x, mesh, tuple(axes)) if axis_size(mesh, axes) > 1 else x


def grad_scale(x, s: float):
    return x if s == 1.0 else _GradScale.apply(x, s)


# ---------------------------------------------------------------------------
# parameters: DTensor storage → plain tensors for compute
# ---------------------------------------------------------------------------
PARTIAL, REPLICATE, KEEP = "partial", "replicate", "keep"


class _Gather(torch.autograd.Function):
    """A stored shard → the tensor gathered over every mesh dim whose
    gradient mode is not KEEP. ``grads[i]`` says what each rank's gradient
    is along mesh dim i: PARTIAL (a part: sum the ranks'), REPLICATE (the
    whole, equal on every rank) or KEEP (not gathered, passed through)."""

    @staticmethod
    def forward(ctx, local, mesh, shard_dims, grads):
        ctx.mesh, ctx.shard_dims, ctx.grads = mesh, shard_dims, grads
        names = axis_names(mesh)
        x = local
        for i in reversed(range(len(names))):
            if grads[i] != KEEP and shard_dims[i] is not None:
                x = all_gather(x, mesh, (names[i],), dim=shard_dims[i])
        return x if x is not local else local.view_as(local)

    @staticmethod
    def backward(ctx, g):
        names = axis_names(ctx.mesh)
        dims = ctx.shard_dims
        done = set()
        # a replicated gradient's slice first, where no other mesh dim shards
        # that tensor dim: the reductions then move only this rank's part
        for i, (d, mode) in enumerate(zip(dims, ctx.grads)):
            if mode == REPLICATE and d is not None and not any(
                    dims[j] == d and ctx.grads[j] != KEEP for j in range(len(dims)) if j != i):
                g = local_block(g, ctx.mesh, (names[i],), dim=d)
                done.add(i)
        for i, (d, mode) in enumerate(zip(dims, ctx.grads)):
            if mode == KEEP or i in done:
                continue
            if d is None:
                if mode == PARTIAL:
                    g = all_reduce(g, ctx.mesh, (names[i],))
            elif mode == PARTIAL:
                g = reduce_scatter(g, ctx.mesh, (names[i],), dim=d)
            else:
                g = local_block(g, ctx.mesh, (names[i],), dim=d)
        return g.contiguous(), None, None, None


def shard_dims(dt) -> tuple:
    """Per mesh dim of a DTensor: the tensor dim it shards, or None."""
    from torch.distributed.tensor import Shard
    return tuple(p.dim if isinstance(p, Shard) else None for p in dt.placements)


def gather(dt, grads: tuple) -> torch.Tensor:
    """``dt`` (a DTensor) as a plain tensor gathered over every mesh dim
    whose mode in ``grads`` is not KEEP (see `_Gather`); differentiable
    into ``dt``'s gradient, which lands on its stored shard."""
    local = dt.to_local()
    dims = shard_dims(dt)
    if all(m == KEEP or d is None for d, m in zip(dims, grads)) and not torch.is_grad_enabled():
        return local
    return _Gather.apply(local, dt.device_mesh, dims, tuple(grads))


def local_shard_bytes(tree) -> int:
    """Bytes of the local shards of a tree's DTensors (plain tensors whole)."""
    from repro_torch.optim.optimizers import leaves
    total = 0
    for x in leaves(tree):
        loc = x.to_local() if hasattr(x, "to_local") else x
        total += loc.numel() * loc.element_size()
    return total


def distribute(x: torch.Tensor, mesh, placements: tuple, requires_grad: bool = False):
    """A full tensor held alike by every rank → the DTensor of its shard
    (each rank slices its own block; nothing is sent)."""
    from torch.distributed.tensor import distribute_tensor
    dt = distribute_tensor(x.detach(), mesh, list(placements), src_data_rank=None)
    return torch.nn.Parameter(dt, requires_grad=requires_grad)


ROUTED = (".moe.wi", ".moe.wg", ".moe.wo")


@dataclasses.dataclass
class MeshCompute:
    """What one rank's forward needs on a mesh (`transformer.forward`,
    `loss_fn`, `prefill`, `decode_step` take it as ``mesh``, where the
    reference takes its jax mesh):

    * ``mesh``: the `DeviceMesh`;
    * ``named``: the stored DTensor of each parameter, by the port's
      parameter name (``periods.3.0.attn.wq``; with ``learner_axis`` each
      leads with the learner dim, Shard(0) over that axis);
    * ``batch_sharded``: whether the batch axes hold distinct tokens (the
      batch divides them, `launch/specs.py`), so that each rank's
      gradient is a part to be summed over them, or the same tokens;
    * ``weight_stationary``: decode's MoE path.

    MoE layers take `moe_ffn_sharded` when the ``model`` axis is wider
    than 1 (and not inside a gossip learner, where the reference runs the
    local path); their routed weights are then handed over as DTensors,
    never gathered over ``model``."""
    mesh: object
    named: dict
    cfg: object
    batch_sharded: bool = True
    learner_axis: str | None = None
    weight_stationary: bool = False
    batch_over: tuple | None = None    # the dp layout: the batch spans these axes

    @property
    def moe_sharded(self) -> bool:
        return (self.learner_axis is None and "model" not in self.batch_axes()
                and axis_size(self.mesh, ("model",)) > 1)

    def batch_axes(self) -> tuple[str, ...]:
        if self.batch_over is not None:
            return tuple(self.batch_over)
        return tuple(a for a in axis_names(self.mesh) if a not in ("model", self.learner_axis))

    def activation_placements(self) -> tuple:
        """Placements of a (B, …) activation: Shard(0) over the batch axes
        when they hold distinct tokens, else replicated."""
        from torch.distributed.tensor import Replicate, Shard
        return tuple(Shard(0) if self.batch_sharded and a in self.batch_axes() else Replicate()
                     for a in axis_names(self.mesh))

    def modes(self, name: str) -> tuple:
        """Gradient mode of a parameter along each mesh dim (`_Gather`)."""
        router = self.moe_sharded and name.endswith(".moe.router")
        ws = ()
        if router and self.weight_stationary:
            from repro_torch.models.moe import moe_layout
            ws = moe_layout(self.cfg, 0, self.mesh, True)[1]
        out = []
        batch = self.batch_axes()
        for a in axis_names(self.mesh):
            if a == self.learner_axis:
                out.append(KEEP)
            elif a in batch:
                out.append(PARTIAL if self.batch_sharded or a in ws else REPLICATE)
            else:
                out.append(PARTIAL if router else REPLICATE)
        return tuple(out)

    def gather(self, name: str):
        """Parameter ``name`` for compute: a plain tensor (the learner's
        own with ``learner_axis``), or the DTensor itself for a routed
        expert weight on the sharded MoE path."""
        dt = self.named[name]
        if self.moe_sharded and name.endswith(ROUTED):
            return dt
        x = gather(dt, self.modes(name))
        return x[0] if self.learner_axis is not None else x

    def period_params(self, p: int, period) -> dict:
        """Period ``p``'s parameters for `torch.func.functional_call` on a
        module holding the period as ``period``."""
        return {f"period.{n}": self.gather(f"periods.{p}.{n}") for n, _ in period.named_parameters()}
