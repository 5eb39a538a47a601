"""Serving launcher: the prefill and decode steps — port of
`src/repro/launch/serve.py` (all of it: `serve_param_shardings`,
`make_prefill_step`, `make_decode_step`), on one device and on a mesh.

Each maker resolves its device (cuda unless the caller asks for cpu; it
raises otherwise) and returns a callable that runs under
`torch.inference_mode()` and refuses a model on another device. The
reference donates the decode cache to its jitted step; here the step
writes into the cache tensors passed in and returns the same dict.

    step = make_prefill_step(cfg, device="cuda")
    logits, pcache = step(model, {"tokens": tokens})         # (B, 1, vocab)
    cache = cache_from_prefill(cfg, pcache, seq_len=S + n, device="cuda")
    decode = make_decode_step(cfg, device="cuda")
    logits, cache = decode(model, cache, next_tokens, S)     # position S

On a mesh (``mesh=``, a `DeviceMesh`; every rank passes the same global
tokens): `shard_for_serving` stores the parameters as
`serve_param_shardings` lays them out (weight-stationary when
``cfg.serve_weight_stationary``); each period's are gathered before use
(`sharding.spmd`), MoE layers expert-parallel. The prefill returns this
rank's batch rows as DTensors (logits (B, 1, vocab) and caches over the
full prompt); `cache_from_prefill(..., mesh=, cache_pspecs=)` lays them
into a decode cache as `launch/specs.py::cache_specs` says, each rank
keeping only its slice of the positions. Decode keeps the cache sharded
and never gathers it (`transformer.decode_step`): each rank attends over
its positions, the partial softmaxes are merged by all-reduces, and the
rank that holds ``pos`` writes the new entry. Its logits are a DTensor
over the batch axes (``full_tensor()`` gathers them).
"""
from __future__ import annotations

import torch

from repro_torch import device as device_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import rules, spmd


def serve_param_shardings(cfg: ModelConfig, mesh, *, fsdp: bool = True,
                          weight_stationary: bool = False) -> dict:
    """The parameters' specs for serving (a `rules.params_pspecs` tree
    over the reference's paths; `rules.placements` makes placements of
    each). ``weight_stationary``: weights resident — no FSDP dim on the
    embed axis; MoE expert hidden dim sharded over data instead (matches
    `moe_ffn_sharded`'s ws path)."""
    overrides = dict(rules.SERVE_WS_OVERRIDES) if weight_stationary else None
    return rules.params_pspecs(transformer.param_specs(cfg), transformer.param_shapes(cfg), mesh,
                               fsdp=fsdp, overrides=overrides)


def shard_for_serving(model: transformer.Transformer, mesh, *, fsdp: bool = True,
                      weight_stationary: bool | None = None) -> transformer.Transformer:
    """``model`` (held alike by every rank) with each parameter replaced by
    its shard, as `serve_param_shardings` lays it out (weight-stationary
    per ``cfg.serve_weight_stationary`` unless given). In place."""
    ws = model.cfg.serve_weight_stationary if weight_stationary is None else weight_stationary
    pspecs = serve_param_shardings(model.cfg, mesh, fsdp=fsdp and not ws, weight_stationary=ws)
    return transformer.distribute_params(model, mesh, pspecs)


def _compute(model, cfg: ModelConfig, mesh, B: int, weight_stationary: bool = False):
    """(the `MeshCompute` of a call at global batch B, the batch axes)."""
    axes = mesh_lib.batch_axes(mesh)
    sharded = B % spmd.axis_size(mesh, axes) == 0
    return spmd.MeshCompute(mesh, dict(model.named_parameters()), cfg, batch_sharded=sharded,
                            weight_stationary=weight_stationary), axes


def _rows(x: torch.Tensor, ctx, axes) -> torch.Tensor:
    return spmd.local_block(x, ctx.mesh, axes) if ctx.batch_sharded else x


def _batch_dtensor(local: torch.Tensor, ctx, dim: int = 0):
    """A rank's rows (``dim`` the batch) as a DTensor over the batch axes."""
    from torch.distributed.tensor import DTensor, Shard
    placements = tuple(Shard(dim) if isinstance(p, Shard) else p
                       for p in ctx.activation_placements())
    return DTensor.from_local(local, ctx.mesh, placements, run_check=False)


def _require(model: transformer.Transformer, cfg: ModelConfig, dev: torch.device) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the model is {model.cfg.name}'s, the step {cfg.name}'s")
    if model.device != dev:
        raise ValueError(f"the model lies on {model.device}, the step runs on {dev}")


def make_prefill_step(cfg: ModelConfig, device="cuda", mesh=None):
    """``prefill_step(model, batch)`` → (last-position logits, cache);
    ``batch`` holds ``tokens`` and, for vision models, ``media``. On a
    ``mesh``: the global batch in, this rank's rows out as DTensors."""
    dev = device_lib.resolve(device)

    def prefill_step(model, batch):
        _require(model, cfg, dev)
        with torch.inference_mode():
            if mesh is None:
                return transformer.prefill(model, batch["tokens"], media=batch.get("media"))
            ctx, axes = _compute(model, cfg, mesh, batch["tokens"].shape[0])
            media = batch.get("media")
            logits, cache = transformer.prefill(
                model, _rows(batch["tokens"], ctx, axes),
                media=None if media is None else _rows(media, ctx, axes), mesh=ctx)
            return (_batch_dtensor(logits, ctx),
                    {pos: {k: _batch_dtensor(v, ctx, dim=1) for k, v in leaves.items()}
                     for pos, leaves in cache.items()})

    return prefill_step


def make_decode_step(cfg: ModelConfig, device="cuda", mesh=None, cache_pspecs: dict | None = None):
    """``serve_step(model, cache, tokens, pos)`` → (logits, cache), the
    cache written in place. On a ``mesh``: ``cache`` a tree of DTensors
    laid out by ``cache_pspecs`` (`launch/specs.py::cache_specs`; checked),
    the global tokens in, logits a DTensor over the batch axes."""
    dev = device_lib.resolve(device)

    def serve_step(model, cache, tokens, pos):
        _require(model, cfg, dev)
        with torch.inference_mode():
            if mesh is None:
                return transformer.decode_step(model, cache, tokens, pos)
            for pos_, leaves in cache.items():
                for k, v in leaves.items():
                    want = rules.placements(cache_pspecs[pos_][k], mesh)
                    if tuple(v.placements) != want:
                        raise ValueError(f"cache {pos_}/{k} is laid out {v.placements}, "
                                         f"the step's specs say {want}")
            ctx, axes = _compute(model, cfg, mesh, tokens.shape[0],
                                 weight_stationary=cfg.serve_weight_stationary)
            logits, cache = transformer.decode_step(model, cache, _rows(tokens, ctx, axes), pos,
                                                    mesh=ctx)
            return _batch_dtensor(logits, ctx), cache

    return serve_step


def cache_from_prefill(cfg: ModelConfig, prefill_cache: dict, seq_len: int, device="cuda",
                       mesh=None, cache_pspecs: dict | None = None) -> dict:
    """A decode cache of ``seq_len`` positions holding a prefill's caches,
    spliced as the reference's `test_vlm_cross_cache_decode` does
    (`tests/test_models_smoke.py:118-129`): self-attention leaves at
    [:S], cross (``mk``, ``mv``) and SSM (``conv``, ``state``) leaves as
    they are. A sliding-window ring shorter than the prefill keeps its
    last ``buf`` positions, position t at slot t % buf.

    On a ``mesh``: the prefill's DTensors in, DTensors laid out by
    ``cache_pspecs`` out, each rank filling only its own slots."""
    dev = device_lib.resolve(device)
    if mesh is not None:
        return _cache_from_prefill_mesh(cfg, prefill_cache, seq_len, dev, mesh, cache_pspecs)
    batch = next(iter(next(iter(prefill_cache.values())).values())).shape[1]
    cache = transformer.init_cache(cfg, batch, seq_len, device=dev)
    for pos, leaves in prefill_cache.items():
        for name, v in leaves.items():
            buf = cache[pos][name]
            if name in ("mk", "mv", "conv", "state"):
                buf.copy_(v)
                continue
            n = buf.shape[2]
            t, keep = _ring_sources(v.shape[2], n, torch.arange(n, device=dev))
            buf[:, :, keep] = v[:, :, t[keep]]
    return cache


def _ring_sources(S: int, n: int, slots: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """For ``slots`` of a cache of ``n`` positions filled from a prefill of
    ``S``: the position each slot holds (the last t < S with t = slot mod
    n: a ring shorter than the prefill keeps its last n positions) and
    which slots hold one."""
    t = slots if S <= n else slots + n * ((S - 1 - slots) // n)
    return t, t < S


def _cache_from_prefill_mesh(cfg: ModelConfig, prefill_cache: dict, seq_len: int,
                             dev: torch.device, mesh, cache_pspecs: dict) -> dict:
    from torch.distributed.tensor import DTensor
    names = spmd.axis_names(mesh)
    B = next(iter(next(iter(prefill_cache.values())).values())).shape[1]
    out: dict = {}
    for pos, leaves in prefill_cache.items():
        out[pos] = {}
        for name, v in leaves.items():
            src = v.to_local()                                  # (np, B_l, S or M…, …)
            placements = rules.placements(cache_pspecs[pos][name], mesh)
            dims = [p.dim if hasattr(p, "dim") else None for p in placements]
            seq_axes = tuple(a for a, d in zip(names, dims) if d == 2)
            whole = name in ("mk", "mv", "conv", "state")     # no positions dim
            if whole:
                local, full_len = src, src.shape[2]
            else:
                full_len = _cache_len(cfg, pos, seq_len)
                n_loc = full_len // spmd.axis_size(mesh, seq_axes)
                g = spmd.coordinate(mesh, seq_axes) * n_loc + torch.arange(n_loc, device=dev)
                t, keep = _ring_sources(src.shape[2], full_len, g)
                local = torch.zeros((*src.shape[:2], n_loc, *src.shape[3:]), dtype=src.dtype,
                                    device=dev)
                local[:, :, keep] = src[:, :, t[keep]]
            for a, d in zip(names, dims):      # heads / channels: this rank's block
                if d is not None and d >= (2 if whole else 3):
                    local = spmd.local_block(local, mesh, (a,), dim=d)
            shape = (src.shape[0], B, full_len, *src.shape[3:])
            out[pos][name] = DTensor.from_local(local.contiguous(), mesh, placements,
                                                run_check=False, shape=torch.Size(shape),
                                                stride=_contiguous_stride(shape))
    return out


def _cache_len(cfg: ModelConfig, pos: str, seq_len: int) -> int:
    spec = cfg.period[int(pos)]
    return min(seq_len, spec.sliding_window) if spec.sliding_window else seq_len


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))
