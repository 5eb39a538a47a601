"""Multi-pod dry run — port of `src/repro/launch/dryrun.py` (`lower_combo`,
`_lower_one`, `_state_shardings`, `main` with ``--arch``, ``--shape``,
``--all``, ``--multi-pod``, ``--sync``, ``--opt``, ``--force``).

For every (architecture × input shape × mesh) the reference lowers and
compiles its step on 256 or 512 placeholder devices and reads FLOPs,
memory and collective bytes from XLA. Here one process joins a fake
process group of the mesh's size (`torch.testing._internal.distributed.
fake_pg`: collectives return at once), and rank 0 runs the port's own
step once on `FakeTensorMode` tensors: shapes and dtypes only, nothing
allocated. The step is the one a rank of a live mesh runs
(`launch/train.py`, `launch/serve.py` with ``mesh=``), so what it records
is per device:

* ``hlo_flops_per_device``: `torch.utils.flop_counter.FlopCounterMode`;
* ``collective_bytes_per_device``: a `TorchDispatchMode` sums the output
  bytes of every `c10d` / `_c10d_functional` collective the rank issues,
  by kind (all-gather, all-reduce, reduce-scatter; send/receive counted
  as collective-permute) — the reference's `collective_bytes` definition
  on HLO;
* ``argument_size_bytes`` (the rank's local shards of the state, or of
  the parameters and cache, and its batch), ``output_size_bytes`` and
  wall seconds.

The port runs every period eagerly, so no scan body is counted once and
the reference's 1- and 2-period calibration is not needed; the
``corrected_*`` fields are kept, equal to the raw values, so that records
compare. Records go to the git-ignored ``build/dryrun/`` (the JAX
package's are in ``benchmarks/results/dryrun/``). A combination that fails
is recorded with its error and the run exits 1; ``long_500k`` on a
full-attention architecture is skipped with the reference's reason.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-4b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--sync gossip]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --small     # CI scale: a fake (2,4)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import registry
from repro_torch.core.gossip import GossipConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve, specs
from repro_torch.launch import train as train_lib
from repro_torch.models import config as mc
from repro_torch.models import transformer
from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.optim import adamw
from repro_torch.sharding import rules, spmd

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"

# the CI-scale combinations of tests/test_sharding.py:62-66, on a (2, 4) mesh
SMALL = {
    "minitron-4b": dict(n_kv_heads=4, vocab_size=512),
    "deepseek-v2-236b": dict(vocab_size=512, n_routed_experts=8),
    "jamba-1.5-large-398b": dict(vocab_size=512, n_routed_experts=8, ssm_head_dim=64,
                                 n_kv_heads=4),
}
SMALL_SHAPES = {"train": InputShape("train", 256, 8, "train"),
                "decode": InputShape("decode", 512, 8, "decode")}
SKIP_LONG = "full-attention arch: long_500k requires sub-quadratic attention (DESIGN.md §5)"

_KINDS = {  # collective op name (c10d and _c10d_functional) -> the reference's HLO kind
    "allreduce_": "all-reduce", "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all", "all_to_all_single": "all-to-all",
    "recv_": "collective-permute", "recv_any_source_": "collective-permute",
    "broadcast_": "broadcast",
}


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(y) for y in x)
    return 0


class CollectiveBytes(TorchDispatchMode):
    """Sums the output bytes of each collective this rank issues, by kind.
    In-place c10d ops count the tensors they write (an all-reduce's
    buffer, an all-gather's output, a receive's buffer); a send writes
    nothing here and is counted at its receive."""

    def __init__(self):
        super().__init__()
        self.bytes: dict[str, int] = {}
        self.calls: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns in ("c10d", "_c10d_functional") and name in _KINDS:
            kind = _KINDS[name]
            # functional ops return their output; c10d's write their first
            # argument (the output tensor or list, or the buffer in place)
            n = _bytes(out) if ns == "_c10d_functional" else _bytes(args[0])
            self.bytes[kind] = self.bytes.get(kind, 0) + n
            self.calls[kind] = self.calls.get(kind, 0) + 1
        return out


def _fake_group(size: int) -> None:
    """A fake process group of ``size`` ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def _fake_local(meta: torch.Tensor, spec, mesh):
    """A fake DTensor laid out by ``spec`` for a meta stand-in."""
    from torch.distributed.tensor import DTensor
    placements = rules.placements(spec, mesh)
    shape = list(meta.shape)
    names = spmd.axis_names(mesh)
    for a, p in zip(names, placements):
        if hasattr(p, "dim"):
            shape[p.dim] //= mesh.size(names.index(a))
    local = torch.zeros(shape, dtype=meta.dtype)
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=meta.shape,
                              stride=serve._contiguous_stride(tuple(meta.shape)))


def _global(meta: torch.Tensor) -> torch.Tensor:
    return torch.zeros(meta.shape, dtype=meta.dtype)


def _model(cfg: ModelConfig) -> transformer.Transformer:
    return transformer.Transformer(cfg, device="cpu")


def _run_one(cfg: ModelConfig, shape: InputShape, mesh, *, sync: str, opt: str | None) -> dict:
    """One step of (cfg, shape) on a fake rank 0 of ``mesh``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    coll = CollectiveBytes()
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        if shape.kind == "train":
            overrides = rules.DP_OVERRIDES if opt == "dp" else None
            gcfg = None
            if opt == "gossip_d1":
                sync, gcfg = "gossip", GossipConfig(walk_length=1)
            elif opt == "gossip_pod":
                sync, gcfg = "gossip", GossipConfig(learner_axis="pod", walk_length=1)
            step, init_fn = train_lib.make_train_step(
                cfg, adamw(3e-4), sync=sync, gossip=gcfg, device="cpu", mesh=mesh,
                rules_overrides=overrides)
            state = init_fn(model=_model(cfg))
            batch_over = train_lib.train_batch_axes(mesh, overrides)
            metas, _ = specs.batch_specs(cfg, shape, mesh, batch_over=batch_over)
            batch = {k: _global(v) for k, v in metas.items()}
            args = spmd.local_shard_bytes([state.params if isinstance(state.params, dict)
                                           else transformer.param_tree(state.params),
                                           state.opt_state])
            params_bytes = spmd.local_shard_bytes(
                state.params if isinstance(state.params, dict)
                else transformer.param_tree(state.params))
            run = lambda: step(state, batch)
        elif shape.kind == "prefill":
            model = serve.shard_for_serving(_model(cfg), mesh, weight_stationary=False)
            metas, _ = specs.batch_specs(cfg, shape, mesh)
            batch = {k: _global(v) for k, v in metas.items() if k != "labels"}
            params_bytes = args = spmd.local_shard_bytes(transformer.param_tree(model))
            step = serve.make_prefill_step(cfg, device="cpu", mesh=mesh)
            run = lambda: step(model, batch)
        else:
            model = serve.shard_for_serving(_model(cfg), mesh)
            d = specs.decode_specs(cfg, shape, mesh)
            cache = {pos: {k: _fake_local(v, d.cache_pspecs[pos][k], mesh) for k, v in leaves.items()}
                     for pos, leaves in d.cache.items()}
            params_bytes = spmd.local_shard_bytes(transformer.param_tree(model))
            args = params_bytes + spmd.local_shard_bytes(cache)
            step = serve.make_decode_step(cfg, device="cpu", mesh=mesh, cache_pspecs=d.cache_pspecs)
            tokens = _global(d.tokens)
            run = lambda: step(model, cache, tokens, shape.seq_len - 1)
            batch = {"tokens": tokens}
        B = shape.global_batch
        n = spmd.axis_size(mesh, batch_over if shape.kind == "train" else mesh_lib.batch_axes(mesh))
        rows = B // n if B % n == 0 else B
        args += sum(_bytes(v) * rows // B for v in batch.values())
        t_setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        flops = FlopCounterMode(display=False)
        with flops, coll:
            out = run()
        t_run = time.perf_counter() - t0
        out_bytes = spmd.local_shard_bytes(_tensors(out))
    total_flops = float(flops.get_total_flops())
    return {
        "arch": cfg.name, "shape": shape.name,
        "mesh": "x".join(str(mesh.size(i)) for i in range(mesh.ndim)),
        "sync": sync, "setup_s": t_setup, "run_s": t_run,
        "hlo_flops_per_device": total_flops,
        "collective_bytes_per_device": dict(coll.bytes),
        "collective_calls_per_device": dict(coll.calls),
        "argument_size_bytes": int(args), "param_bytes_per_device": int(params_bytes),
        "output_size_bytes": int(out_bytes),
        "corrected_flops_per_device": total_flops,
        "corrected_collective_bytes_per_device": dict(coll.bytes),
        "n_devices": mesh.size(),
    }


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, torch.nn.Module):
        return list(x.parameters())
    return []


def lower_combo(arch: str, shape_name: str, mesh, *, sync: str = "allreduce",
                opt: str | None = None, cfg: ModelConfig | None = None,
                shape: InputShape | None = None) -> dict:
    """Run (arch, shape) once on ``mesh`` (a `DeviceMesh` of a fake group)
    and return its record; ``cfg`` / ``shape`` replace the registry's."""
    cfg = cfg or registry.get_config(arch)
    shape = shape or INPUT_SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.supports_long_context_decode:
        return {"skipped": SKIP_LONG}
    if opt == "tri":
        cfg = dataclasses.replace(cfg, triangular_attention=True)
    elif opt == "serve_ws":
        cfg = dataclasses.replace(cfg, serve_weight_stationary=True)
    res = _run_one(cfg, shape, mesh, sync=sync, opt=opt)
    res["opt"] = opt
    return res


def _combos(args) -> list[tuple[str, str, ModelConfig | None, InputShape | None]]:
    if args.small:
        return [(a, s, mc.reduced(registry.get_config(a), **over), shp)
                for a, over in SMALL.items() for s, shp in SMALL_SHAPES.items()
                if args.arch in (None, a) and args.shape in (None, s)]
    archs = registry.ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    return [(a, s, None, None) for a in archs for s in shapes]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Per-device FLOPs, memory and collective bytes "
                                             "of each step on a fake 256/512-rank group.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--sync", default="allreduce", choices=["allreduce", "gossip"])
    ap.add_argument("--opt", default=None,
                    choices=[None, "tri", "serve_ws", "dp", "gossip_d1", "gossip_pod"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--small", action="store_true",
                    help="the CI-scale reduced combinations on a fake (2, 4) mesh")
    ap.add_argument("--out", type=pathlib.Path, default=RESULTS)
    args = ap.parse_args(argv)

    shape = (mesh_lib.make_test_mesh(2, 4) if args.small
             else mesh_lib.make_production_mesh(multi_pod=args.multi_pod))
    _fake_group(shape.size)
    mesh = mesh_lib.device_mesh(shape, "cpu")
    args.out.mkdir(parents=True, exist_ok=True)
    where = "x".join(map(str, shape.sizes)) if args.small else (
        "multipod" if args.multi_pod else "pod")
    n_ok = n_skip = n_fail = 0
    for arch, shape_name, cfg, shp in _combos(args):
        tag = f"{arch}__{shape_name}__{where}__{args.sync}"
        if args.opt:
            tag += f"__{args.opt}"
        out_path = args.out / f"{tag}.json"
        if out_path.exists() and not args.force:
            print(f"[cached] {tag}")
            n_ok += 1
            continue
        print(f"[run   ] {tag} ...", flush=True)
        try:
            res = lower_combo(arch, shape_name, mesh, sync=args.sync, opt=args.opt, cfg=cfg,
                              shape=shp)
        except Exception as e:
            res = {"error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            n_fail += 1
            print(f"[FAIL  ] {tag}: {res['error']}")
        else:
            if "skipped" in res:
                n_skip += 1
                print(f"[skip  ] {tag}: {res['skipped']}")
            else:
                n_ok += 1
                print(f"[ok    ] {tag}: run={res['run_s']:.1f}s "
                      f"flops/dev={res['hlo_flops_per_device']:.3e} "
                      f"coll={ {k: f'{v:.2e}' for k, v in res['collective_bytes_per_device'].items()} }")
        out_path.write_text(json.dumps(res, indent=1))
    print(f"done: ok={n_ok} skip={n_skip} fail={n_fail}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
