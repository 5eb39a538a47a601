"""Meshes and local learner groups — port of `src/repro/launch/mesh.py`:
the production and test meshes with `batch_axes` and `n_batch_shards`
(:44-66), and `spawn_ranks`, the port's device provisioner, its
counterpart of `ensure_host_platform_devices` (:14). The reference's
`shard_map` compatibility shim (:28) is JAX idiom with no counterpart: a
rank runs its own shard's program over `torch.distributed`.

A mesh has the reference's axis names, ``("data", "model")`` or ``("pod",
"data", "model")``. The abstract mesh is separate from the live one:
`make_production_mesh` and `make_test_mesh` return a frozen `MeshShape`
(axis names, name → size), which is all spec resolution needs
(`sharding/rules.py`, `launch/specs.py`); `device_mesh` binds one to
`init_device_mesh` on a live process group of exactly that many ranks.

    shape = make_test_mesh(2, 2)                 # MeshShape, no process group
    mesh = device_mesh(shape, "cuda")            # inside a 4-rank group

`spawn_ranks` starts one process per rank and joins them into a
`torch.distributed` process group:

    from repro_torch.launch.mesh import spawn_ranks
    first = spawn_ranks(train_one_rank, 2, backend="gloo", device="cpu", args=(cfg,))

Each rank is a fresh process (the ``spawn`` start method: CUDA cannot be
forked once initialised). The ranks meet through a `FileStore` in a new
temporary directory, so no TCP port is taken and concurrent groups never
collide. The backend is the caller's choice and is never switched: nccl
needs one card per rank; gloo serves CPU ranks, and several ranks on one
card (each rank on card ``rank % device_count``).

``fn(rank, *args)`` must be a module-level function (the spawned process
imports it by name) and return something picklable; rank 0's return value
is returned. Build the CUDA kernels (`kernels.build.load`) before calling,
so that no two ranks compile into the same directory at once.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import device as device_lib

BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """An abstract mesh: axis names in mesh order and their sizes."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 = 256 devices; (2,16,16) = 512 across 2 pods."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_test_mesh(n_data: int = 2, n_model: int = 4, multi_pod: bool = False) -> MeshShape:
    """Small mesh for CI-scale sharding tests."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, n_data, n_model))
    return MeshShape(("data", "model"), (n_data, n_model))


def batch_axes(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    return tuple(a for a in names if a != "model")


def n_batch_shards(mesh) -> int:
    shape = mesh.shape if isinstance(mesh.shape, dict) else dict(zip(mesh.mesh_dim_names,
                                                                      mesh.shape))
    return math.prod(shape[a] for a in batch_axes(mesh))


def device_mesh(shape: MeshShape, device="cuda"):
    """``shape`` as a live `DeviceMesh` on the current process group, whose
    world size must equal ``shape.size``; ``device`` cuda or cpu (raises
    for cuda without a card)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("device_mesh needs an initialised process group")
    if dist.get_world_size() != shape.size:
        raise ValueError(f"a {shape.sizes} mesh needs {shape.size} ranks, the group has "
                         f"{dist.get_world_size()}")
    dev = device_lib.resolve(device)
    return init_device_mesh(dev.type, shape.sizes, mesh_dim_names=shape.axis_names)


def _rank_device(device: str, rank: int) -> None:
    """A cuda rank's current card: ``rank % device_count``."""
    if torch.device(device).type == "cuda":
        device_lib.resolve("cuda")
        torch.cuda.set_device(rank % torch.cuda.device_count())


def _rank_main(fn, rank: int, n: int, backend: str, device: str, store_path: str,
               timeout_s: float, results, args) -> None:
    """One rank's process: settle the CPU, join the group, run ``fn``,
    leave the group; report ("ok", rank, value) or ("err", rank, traceback)."""
    try:
        device_lib.settle_cpu()
        _rank_device(device, rank)
        store = dist.FileStore(store_path, n)
        dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put(("ok", rank, out if rank == 0 else None))
    except BaseException:   # every failure goes to the parent, then on up
        results.put(("err", rank, traceback.format_exc()))
        raise


def check_backend(backend: str, n: int, device: str) -> None:
    """Raise if ``n`` ranks cannot run on ``backend`` and ``device``: an
    unknown backend, nccl off the card, or nccl with more ranks than
    visible cards."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} (one of {BACKENDS})")
    if n < 1:
        raise ValueError(f"n={n} ranks")
    if backend == "nccl":
        if torch.device(device).type != "cuda":
            raise ValueError("the nccl backend runs on cuda ranks only; use gloo for cpu")
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > cards:
            raise RuntimeError(f"nccl needs one card per rank: {n} ranks, {cards} cards "
                               "visible (gloo runs several ranks on one card)")
    if torch.device(device).type == "cuda":
        device_lib.resolve("cuda")             # raises without a card


def _failures(results, errors: dict, n: int, n_done: int, grace_s: float = 3.0) -> str:
    """Every failing rank's traceback: after the first, the others that
    arrive within ``grace_s`` (a rank's failure makes its peers' collectives
    fail too, and their reports may arrive first)."""
    end = time.monotonic() + grace_s
    while n_done + len(errors) < n and time.monotonic() < end:
        try:
            status, rank, value = results.get(timeout=0.1)
        except queue.Empty:
            continue
        if status == "err":
            errors[rank] = value
        else:
            n_done += 1
    return "\n".join(f"rank {r} of {n} raised:\n{errors[r]}" for r in sorted(errors))


def spawn_ranks(fn, n: int, *, backend: str, device: str, timeout_s: float = 600.0,
                args: tuple = ()):
    """Run ``fn(rank, *args)`` in ``n`` spawned ranks of one process group
    and return rank 0's result.

    Every rank is joined within ``timeout_s`` seconds in all (also the
    group's own collective timeout). On a timeout, a rank that exits
    without a result or a rank that raises, the others are terminated and
    this raises `RuntimeError` with the failing ranks' tracebacks."""
    check_backend(backend, n, device)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank{rank}",
                         args=(fn, rank, n, backend, device, os.path.join(tmp, "store"),
                               timeout_s, results, tuple(args)))
             for rank in range(n)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        done: dict[int, object] = {}
        while len(done) < n:
            try:
                status, rank, value = results.get(timeout=0.2)
            except queue.Empty:
                dead = [p for i, p in enumerate(procs)
                        if i not in done and not p.is_alive() and p.exitcode is not None]
                if dead:
                    # a rank may exit just after queueing its result: read once more
                    try:
                        status, rank, value = results.get(timeout=1.0)
                    except queue.Empty:
                        raise RuntimeError(f"{dead[0].name} exited with code "
                                           f"{dead[0].exitcode} and no result") from None
                elif time.monotonic() > deadline:
                    late = [p.name for i, p in enumerate(procs) if i not in done]
                    raise RuntimeError(f"spawn_ranks: {', '.join(late)} did not finish "
                                       f"within {timeout_s} s")
                else:
                    continue
            if status == "err":
                raise RuntimeError(_failures(results, {rank: value}, n, len(done)))
            done[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
            if p.exitcode not in (0, None):
                raise RuntimeError(f"{p.name} exited with code {p.exitcode}")
        return done[0]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(5.0)
                if p.is_alive():
                    p.kill()
                    p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
