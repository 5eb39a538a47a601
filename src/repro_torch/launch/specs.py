"""Input stand-ins and their shardings for every (arch × shape) — port of
`src/repro/launch/specs.py` (all of it: `_maybe`, `batch_specs`,
`cache_specs`, `decode_specs`).

The reference builds `jax.ShapeDtypeStruct`s that carry their sharding.
Here each function returns meta tensors (shape and dtype, nothing
allocated) and, beside them, the same tree of `PartitionSpec`s
(`sharding/rules.py`), following the reference's policy:

* the batch dim over the batch axes when divisible (else replicated);
* the KV sequence dim over ``model``, or over ``(data, model)`` when the
  batch is 1 (``long_500k``): the sequence-sharded KV design;
* a sliding window's ring resolved on its own length;
* MLA's latent ``ckv`` and rope key ``kr`` likewise;
* cross-attention's media cache over KV heads on ``model``;
* SSM conv channels and state heads over ``model``.

``mesh`` is a `launch.mesh.MeshShape` or a live `DeviceMesh`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.launch.mesh import batch_axes
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.sharding.rules import P, mesh_axes

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _maybe(ax, size, mesh):
    """Mesh axis (or tuple of axes) if divisible, else None (replicate)."""
    _, sizes = mesh_axes(mesh)
    n = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        n *= sizes[a]
    return ax if size % n == 0 else None


def _batch_axis(mesh, B: int, batch_over=None):
    ba = batch_over or batch_axes(mesh)
    return _maybe(ba if len(ba) > 1 else ba[0], B, mesh)


def batch_specs(cfg: ModelConfig, shape: InputShape, mesh, batch_over=None
                ) -> tuple[dict, dict]:
    """Training/prefill batch: tokens + labels (+ media for VLM), and their
    specs. ``batch_over`` overrides the batch axes (the dp layout: the
    whole mesh)."""
    B, S = shape.global_batch, shape.seq_len
    bax = _batch_axis(mesh, B, batch_over)
    tok_shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    tok_spec = P(bax, *([None] * (len(tok_shape) - 1)))
    out = {"tokens": _meta(tok_shape, torch.int32), "labels": _meta(tok_shape, torch.int32)}
    specs = {"tokens": tok_spec, "labels": tok_spec}
    if cfg.n_image_tokens:
        out["media"] = _meta((B, cfg.n_image_tokens, cfg.d_model), DTYPES[cfg.compute_dtype])
        specs["media"] = P(bax, None, None)
    return out, specs


def cache_specs(cfg: ModelConfig, shape: InputShape, mesh) -> tuple[dict, dict]:
    """Decode cache stand-ins with the long-context sharding policy:

    * batch dim -> batch axes (when divisible; batch=1 replicates);
    * KV sequence dim -> the *model* axis when batch occupies data
      (decode_32k), or (data, model) when batch=1 (long_500k);
    * SSM state: heads -> model (O(1) memory, nothing seq-indexed)."""
    ba = batch_axes(mesh)
    B, S = shape.global_batch, shape.seq_len
    bax = _batch_axis(mesh, B)
    if bax is None:
        seq_ax = _maybe(tuple([*ba, "model"]), S, mesh)
    else:
        seq_ax = _maybe("model", S, mesh)
    np_ = cfg.n_periods
    dt = DTYPES[cfg.compute_dtype]
    cache, specs = {}, {}
    for pos, spec in enumerate(cfg.period):
        if spec.kind == "attn":
            Se = min(S, spec.sliding_window) if spec.sliding_window else S
            seq_ax_e = seq_ax if Se == S else _maybe(
                tuple([*ba, "model"]) if bax is None else "model", Se, mesh)
            if cfg.attn_type == "mla":
                shapes = {
                    "ckv": ((np_, B, Se, cfg.kv_lora_rank), P(None, bax, seq_ax_e, None)),
                    "kr": ((np_, B, Se, cfg.rope_head_dim), P(None, bax, seq_ax_e, None)),
                }
            else:
                kvax = _maybe("model", cfg.n_kv_heads, mesh) if seq_ax_e is None else None
                shapes = {
                    "k": ((np_, B, Se, cfg.n_kv_heads, cfg.head_dim),
                          P(None, bax, seq_ax_e, kvax, None)),
                    "v": ((np_, B, Se, cfg.n_kv_heads, cfg.v_head_dim),
                          P(None, bax, seq_ax_e, kvax, None)),
                }
        elif spec.kind == "cross":
            kvax = _maybe("model", cfg.n_kv_heads, mesh)
            shapes = {
                "mk": ((np_, B, cfg.n_image_tokens, cfg.n_kv_heads, cfg.head_dim),
                       P(None, bax, None, kvax, None)),
                "mv": ((np_, B, cfg.n_image_tokens, cfg.n_kv_heads, cfg.v_head_dim),
                       P(None, bax, None, kvax, None)),
            }
        else:
            cdim = ssm_lib.conv_dim(cfg)
            shapes = {
                "conv": ((np_, B, cfg.ssm_conv_width - 1, cdim),
                         P(None, bax, None, _maybe("model", cdim, mesh))),
                "state": ((np_, B, cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_d_state),
                          P(None, bax, _maybe("model", cfg.ssm_n_heads, mesh), None, None)),
            }
        cache[str(pos)] = {k: _meta(sh, torch.float32 if k == "state" else dt)
                           for k, (sh, _) in shapes.items()}
        specs[str(pos)] = {k: sp for k, (_, sp) in shapes.items()}
    return cache, specs


class DecodeSpecs(NamedTuple):
    """serve_step inputs: the cache, tokens (B, 1), pos (), and their specs."""
    cache: dict
    cache_pspecs: dict
    tokens: torch.Tensor
    pos: torch.Tensor
    tokens_spec: P
    pos_spec: P


def decode_specs(cfg: ModelConfig, shape: InputShape, mesh) -> DecodeSpecs:
    B = shape.global_batch
    bax = _batch_axis(mesh, B)
    cache, cache_pspecs = cache_specs(cfg, shape, mesh)
    tok_shape = (B, 1, cfg.n_codebooks) if cfg.n_codebooks else (B, 1)
    return DecodeSpecs(cache, cache_pspecs, _meta(tok_shape, torch.int32),
                       _meta((), torch.int32), P(bax, *([None] * (len(tok_shape) - 1))), P())
