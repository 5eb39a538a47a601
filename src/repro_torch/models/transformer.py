"""Composable decoder stack covering all assigned architecture families —
port of `src/repro/models/transformer.py` (all of it): `init_params`
(:66) with the logical-axis spec tree it returns (`param_specs`),
`abstract_params` (:105), `_embed`, `_apply_layer`, `forward` (with its
remat, :210), `_lm_head`, `loss_fn` (:224-242), `prefill`, `init_cache`,
`decode_step` (:121-374), each with the reference's ``mesh`` argument.

The model is ``n_periods`` repeated periods; within a period, layers
follow ``cfg.period``:

    layer = x + mixer(norm(x));  x = x + ffn(norm(x))      (ffn optional)

mixers: GQA self-attention (with qkv bias, with a sliding-window ring
buffer), MLA self-attention (with and without q-LoRA), Mamba2-SSD, gated
cross-attention (VLM image layers); ffns: dense SwiGLU or MoE. Audio
models sum one embedding table a codebook and have one head a codebook.

PyTorch's idiom: one `nn.Module` a layer kind, a `Transformer` holding an
`nn.ModuleList` of periods (each an `nn.ModuleList` of `Layer`s). The
reference stacks each period-position's parameters over periods
(``blocks/<pos>/<leaf>[p]``); `params_from_numpy` undoes that stacking.
Caches keep the reference's layout, ``{pos: {"k","v"} | {"ckv","kr"} |
{"mk","mv"} | {"conv","state"}}`` stacked over periods on axis 0;
`decode_step` writes its new entries into the cache tensors passed in (the
reference donates the cache) and returns the same dict.

Three entry points, as in the reference: ``loss_fn`` (the training
forward and chunked cross-entropy, `launch/train.py`; its gradient is
autograd's over these modules), ``prefill`` (forward returning
last-position logits and caches) and ``decode_step`` (one token against a
cache), which serve (`launch/serve.py`).

On a mesh (``mesh=``, a `sharding.spmd.MeshCompute`) the same functions
run one rank's share: `distribute_params` stores each parameter as the
DTensor of its shard (`sharding/rules.py`), each period's are gathered
just before use (`_on_period`, inside the remat checkpoint), MoE layers
go through `moe_ffn_sharded` when ``model`` is wider than 1 (:170, :355),
and `decode_step` attends over a cache whose positions lie over the mesh
(`_decode_mixer`).

Remat: where the reference wraps its period body in `jax.checkpoint`
(``cfg.remat``), the port runs each period under
`torch.utils.checkpoint.checkpoint` (non-reentrant) when grad is enabled,
so a period's activations are recomputed in the backward and only its
input is kept; under `torch.inference_mode` (serving) nothing changes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch import device as device_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.sharding import spmd
from repro_torch.utils import tree as tree_lib

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


# ---------------------------------------------------------------------------
# modules (init)
# ---------------------------------------------------------------------------
class Layer(nn.Module):
    """`_init_layer` (:40-63): ``ln1``; the mixer (``attn``: GQA, MLA or
    cross; or ``mamba``); then ``ln2`` with ``moe`` or ``mlp`` where the
    layer has an FFN."""

    def __init__(self, spec: LayerSpec, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.ln1 = L.init_rms_norm(cfg.d_model, device)
        if spec.kind == "attn":
            self.attn = (attn_lib.MLAAttention(cfg, **kw) if cfg.attn_type == "mla"
                         else attn_lib.GQAAttention(cfg, **kw))
        elif spec.kind == "cross":
            self.attn = attn_lib.CrossAttention(cfg, **kw)
        elif spec.kind == "mamba":
            self.mamba = ssm_lib.Mamba(cfg, **kw)
        else:
            raise ValueError(spec.kind)
        if cfg.d_ff or spec.moe:
            self.ln2 = L.init_rms_norm(cfg.d_model, device)
            if spec.moe:
                self.moe = moe_lib.MoE(cfg, **kw)
            else:
                self.mlp = L.MLP(cfg.d_model, cfg.d_ff, **kw)


class Transformer(nn.Module):
    """The parameter tree of `init_params` (:66-102) as modules:
    ``periods[p][pos]`` is period p's layer at position pos; ``embed``
    (vocab, d) or (n_q, vocab, d); ``lm_head`` (d, vocab) or (n_q, d,
    vocab), absent when tied; ``media_proj`` (d, d) for vision models;
    ``final_norm``. All float32 (``param_dtype``).

    ``device`` is resolved by `repro_torch.device.resolve` (cuda unless the
    caller asks for cpu) or is ``"meta"`` (shapes only). Without a
    ``generator`` the storage is left uninitialised: `init_params` draws
    it, `params_from_numpy` fills it."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = torch.device("meta") if str(device) == "meta" else device_lib.resolve(device)
        kw = dict(generator=generator, device=dev)
        self.cfg = cfg
        self.periods = nn.ModuleList(
            nn.ModuleList(Layer(spec, cfg, **kw) for spec in cfg.period)
            for _ in range(cfg.n_periods))
        if cfg.n_codebooks:  # audio: one table and one head a codebook
            self.embed = L.normal((cfg.n_codebooks, cfg.vocab_size, cfg.d_model), 0.02,
                                  generator, dev)
            self.lm_head = L.normal((cfg.n_codebooks, cfg.d_model, cfg.vocab_size), 0.02,
                                    generator, dev)
        else:
            self.embed = L.init_embedding(cfg.vocab_size, cfg.d_model, **kw)
            if not cfg.tie_embeddings:
                self.lm_head = L.init_lm_head(cfg.d_model, cfg.vocab_size, **kw)
        if cfg.n_image_tokens:  # vlm projector stub: identity-sized projection
            self.media_proj = L.normal((cfg.d_model, cfg.d_model), 0.02, generator, dev)
        self.final_norm = L.init_rms_norm(cfg.d_model, dev)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Transformer:
    """A model drawn on ``device`` from a `torch.Generator` seeded with
    ``seed``, at the reference's distributions and scales (0.02; output
    projections 0.02/sqrt(2·n_layers); zero biases and gate; ones for the
    norms; Mamba's ``A_log``/``dt_bias``/``D``). Not bit-equal to
    `jax.random`: parity with the reference goes through `params_from_numpy`."""
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Transformer(cfg, device=dev, generator=gen)


def abstract_params(cfg: ModelConfig) -> Transformer:
    """The model on the meta device: shapes and bytes, nothing allocated
    (`tree.tree_bytes(abstract_params(cfg))`). The logical-axis specs the
    reference returns beside it are `param_specs(cfg)`; the reference's
    tree of stacked shapes is `param_shapes(cfg)`."""
    return Transformer(cfg, device="meta")


def _layer_specs(spec: LayerSpec, cfg: ModelConfig) -> dict:
    """`_init_layer`'s logical axes (:40-63), unstacked."""
    out: dict = {"ln1": L.RMS_NORM_SPEC}
    if spec.kind == "attn":
        out["attn"] = attn_lib.mla_specs(cfg) if cfg.attn_type == "mla" else attn_lib.gqa_specs(cfg)
    elif spec.kind == "cross":
        out["attn"] = attn_lib.cross_specs(cfg)
    else:
        out["mamba"] = dict(ssm_lib.MAMBA_SPECS)
    if cfg.d_ff or spec.moe:
        out["ln2"] = L.RMS_NORM_SPEC
        if spec.moe:
            out["moe"] = moe_lib.moe_specs(cfg)
        else:
            out["mlp"] = dict(L.MLP_SPECS)
    return out


def param_specs(cfg: ModelConfig) -> dict:
    """The logical-axis spec tree `init_params` returns (:66-102) over the
    reference's parameter tree: each ``blocks/<pos>`` leaf with a leading
    None (the stacking axis over periods is never sharded)."""
    stack = lambda tree: {k: stack(v) if isinstance(v, dict) else (None, *v)
                          for k, v in tree.items()}
    out: dict = {"blocks": {str(pos): stack(_layer_specs(spec, cfg))
                            for pos, spec in enumerate(cfg.period)}}
    if cfg.n_codebooks:
        out["embed"] = (None, *L.EMBEDDING_SPEC)
        out["lm_head"] = (None, *L.LM_HEAD_SPEC)
    else:
        out["embed"] = L.EMBEDDING_SPEC
        if not cfg.tie_embeddings:
            out["lm_head"] = L.LM_HEAD_SPEC
    if cfg.n_image_tokens:
        out["media_proj"] = ("embed", "embed_nodiv")
    out["final_norm"] = L.RMS_NORM_SPEC
    return out


def param_shapes(cfg: ModelConfig, lead: tuple[int, ...] = ()) -> dict:
    """The reference's parameter tree as meta tensors of its stacked shapes
    (``blocks/<pos>/<leaf>`` (n_periods, …)), each with ``lead`` dims in
    front (the learners of `core.gossip.stack_params`); nothing allocated."""
    out: dict = {}
    for path, (shape, _) in _reference_paths(abstract_params(cfg)).items():
        node = out
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = torch.empty((*lead, *shape), dtype=torch.float32, device="meta")
    return out


def reference_names(model: Transformer) -> dict[str, tuple[str, int | None]]:
    """Each named parameter's place in the reference's tree: its
    '/'-joined leaf path and its period along the stacked axis
    (``periods.3.0.attn.wq`` → ``("blocks/0/attn/wq", 3)``), or None for
    a leaf that is not stacked (``embed``, ``lm_head``, ``final_norm``,
    ``media_proj``)."""
    out: dict[str, tuple[str, int | None]] = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "periods":
            out[name] = ("/".join(["blocks", parts[2], *parts[3:]]), int(parts[1]))
        else:
            out[name] = (name, None)
    return out


def _reference_paths(model: Transformer) -> dict[str, tuple[tuple[int, ...], list]]:
    """The reference tree's '/'-joined leaf paths, each with its stacked
    shape and the port parameters it fills, in period order."""
    out: dict[str, tuple[tuple[int, ...], list]] = {}
    where = reference_names(model)
    for name, p in model.named_parameters():
        path, period = where[name]
        if period is not None:
            shape, params = out.setdefault(path, ((model.cfg.n_periods, *p.shape), []))
            params.append(p)
        else:
            out[path] = (tuple(p.shape), [p])
    return out


def leaf_spec(tree: dict, path: str, period: int | None, lead: int = 0) -> tuple:
    """A parameter's entry of a spec tree over the reference's paths: the
    stacked leaf's spec, without its period dim (index ``lead``, after the
    learner dim of a learner-stacked tree) for a per-period parameter; the
    period dim of a stacked block leaf is never sharded."""
    node = tree
    for key in path.split("/"):
        node = node[key]
    if period is None:
        return tuple(node)
    assert node[lead] is None, (path, node)
    return tuple(node[:lead]) + tuple(node[lead + 1:])


def distribute_params(model: Transformer, mesh, pspecs: dict, requires_grad: bool = False
                      ) -> Transformer:
    """Replace each parameter of ``model`` (the same full values on every
    rank) by the DTensor of this rank's shard, laid out by ``pspecs`` (a
    `sharding.rules.params_pspecs` tree over the reference's paths; a
    per-period parameter takes its stacked leaf's spec without the period
    dim). In place; returns ``model``."""
    from repro_torch.sharding import rules
    where = reference_names(model)
    for name, param in list(model.named_parameters()):
        spec = leaf_spec(pspecs, *where[name])
        *parents, leaf = name.split(".")
        owner = model.get_submodule(".".join(parents)) if parents else model
        dt = spmd.distribute(param, mesh, rules.placements(spec, mesh), requires_grad)
        setattr(owner, leaf, dt)
        del param
    return model


def param_tree(model: Transformer) -> dict:
    """The reference's parameter tree over the model's own parameters (no
    copy): ``blocks/<pos>/<leaf>`` is the list of that leaf's parameters,
    one a period in period order (the reference stacks them), every other
    leaf the parameter itself. The optimisers take this tree
    (`repro_torch.optim`), their weight-decay mask seeing the reference's
    paths."""
    out: dict = {}
    for path, (_, params) in _reference_paths(model).items():
        node = out
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = list(params) if path.startswith("blocks/") else params[0]
    return out


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> Transformer:
    """The port's model from the reference's parameter tree as numpy
    float32 arrays (as ``jax.device_get(init_params(cfg, key)[0])`` gives
    it): ``blocks/<pos>/<leaf>[p]`` goes to period p's layer at position
    pos. Raises ValueError on a missing leaf, an extra leaf, a wrong shape
    or a dtype other than float32, before anything is allocated."""
    given = {path: np.asarray(leaf) for path, leaf in tree_lib.tree_paths(tree)}
    want = _reference_paths(abstract_params(cfg))
    missing, extra = sorted(set(want) - set(given)), sorted(set(given) - set(want))
    if missing or extra:
        raise ValueError(f"{cfg.name}: parameter tree mismatch: missing {missing}, extra {extra}")
    for path, (shape, _) in want.items():
        arr = given[path]
        if arr.dtype != np.float32:
            raise ValueError(f"{cfg.name}: {path} is {arr.dtype}, not float32")
        if tuple(arr.shape) != shape:
            raise ValueError(f"{cfg.name}: {path} has shape {tuple(arr.shape)}, want {shape}")
    model = Transformer(cfg, device=device)
    with torch.no_grad():
        for path, (_, params) in _reference_paths(model).items():
            src = torch.from_numpy(np.require(given[path], requirements=["C", "W"]))
            if path.startswith("blocks/"):
                src = src.to(model.device)
                for p, param in enumerate(params):
                    param.copy_(src[p])
            else:
                params[0].copy_(src)
    return model


def params_to_numpy(model: Transformer) -> dict:
    """The inverse of `params_from_numpy`: the model's parameters as the
    reference's tree of numpy float32 arrays, stacked over periods."""
    def host(node):
        if isinstance(node, dict):
            return {key: host(sub) for key, sub in node.items()}
        if isinstance(node, list):
            return np.stack([p.detach().cpu().numpy() for p in node])
        return node.detach().cpu().numpy()

    return host(param_tree(model))


def init_cache_from_numpy(tree: dict, device="cuda") -> dict:
    """A cache in the port from the reference's cache (``{pos: {leaf:
    array}}``, stacked over periods) as numpy float32 arrays. Raises
    ValueError on any other dtype."""
    dev = device_lib.resolve(device)
    out: dict = {}
    for pos, leaves in tree.items():
        out[pos] = {}
        for name, arr in leaves.items():
            arr = np.asarray(arr)
            if arr.dtype != np.float32:
                raise ValueError(f"cache {pos}/{name} is {arr.dtype}, not float32")
            out[pos][name] = torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(dev)
    return out


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------
def _embed(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig, dtype) -> torch.Tensor:
    if cfg.n_codebooks:
        # tokens (B, S, n_q): codebook embeddings summed in float32, then cast
        embs = [params.embed[q][tokens[..., q]] for q in range(cfg.n_codebooks)]
        return sum(embs).to(dtype)
    return params.embed[tokens].to(dtype)


def _ffn(lp: Layer, spec: LayerSpec, x, cfg: ModelConfig, dtype, mesh=None):
    """The layer's FFN residual, x + ffn(norm(x)), and the router's aux;
    on a mesh whose ``model`` axis is wider than 1 a MoE layer takes
    `moe_ffn_sharded` (:170, :355)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if hasattr(lp, "mlp") or hasattr(lp, "moe"):
        h = L.rms_norm(x, lp.ln2, cfg.norm_eps)
        if spec.moe and mesh is not None and mesh.moe_sharded:
            from torch.distributed.tensor import DTensor
            hd = DTensor.from_local(h, mesh.mesh, mesh.activation_placements(), run_check=False)
            y, aux = moe_lib.moe_ffn_sharded(lp.moe, hd, cfg, dtype, mesh.mesh,
                                             weight_stationary=mesh.weight_stationary)
            y = y.to_local()
        elif spec.moe:
            y, aux = moe_lib.moe_ffn_local(lp.moe, h, cfg, dtype)
        else:
            y = L.mlp(lp.mlp, h, dtype)
        x = x + y
    return x, aux


def _apply_layer(lp: Layer, spec: LayerSpec, x, positions, media, cfg: ModelConfig, dtype,
                 collect_cache: bool, mesh=None):
    cache_out = {}
    h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
    if spec.kind == "attn":
        if cfg.attn_type == "mla":
            o, (ckv, kr) = attn_lib.mla_attend_full(lp.attn, h, positions, cfg, dtype,
                                                    cfg.attn_chunk)
            if collect_cache:
                cache_out = {"ckv": ckv, "kr": kr}
        else:
            q, k, v = attn_lib.gqa_qkv(lp.attn, h, positions, cfg, dtype)
            o = attn_lib.blockwise_attention(
                q, k, v, causal=True, kv_chunk=cfg.attn_chunk,
                q_chunk=min(cfg.attn_chunk, 1024),
                triangular=cfg.triangular_attention,
                window=spec.sliding_window,
            )
            o = attn_lib.gqa_out(lp.attn, o, dtype)
            if collect_cache:
                cache_out = {"k": k, "v": v}
    elif spec.kind == "cross":
        o = attn_lib.cross_attend(lp.attn, h, media, cfg, dtype)
        if collect_cache:
            mk = torch.einsum("bmd,dhk->bmhk", media, lp.attn.wk.to(dtype))
            mv = torch.einsum("bmd,dhk->bmhk", media, lp.attn.wv.to(dtype))
            cache_out = {"mk": mk, "mv": mv}
    else:  # mamba
        o, ssm_cache = ssm_lib.mamba_forward(lp.mamba, h, cfg, dtype)
        if collect_cache:
            cache_out = {"conv": ssm_cache.conv, "state": ssm_cache.state}
    x = x + o
    x, aux = _ffn(lp, spec, x, cfg, dtype, mesh)
    return x, aux, cache_out


def _period_body(period: nn.ModuleList, x, aux, positions, media, cfg: ModelConfig, dtype,
                 collect_cache: bool = False, mesh=None):
    """One period's layers (the reference's ``period_body``): returns the
    new (x, aux) and, with ``collect_cache``, each position's cache."""
    caches = {}
    for pos, spec in enumerate(cfg.period):
        x, a, c = _apply_layer(period[pos], spec, x, positions, media, cfg, dtype, collect_cache,
                               mesh)
        aux = aux + a
        caches[str(pos)] = c
    return x, aux, caches


class _Call(nn.Module):
    """A period and a function of it, for `torch.func.functional_call`."""

    def __init__(self, period: nn.ModuleList, fn):
        super().__init__()
        self.period, self.fn = period, fn

    def forward(self, *args):
        return self.fn(self.period, *args)


def _on_period(fn, period: nn.ModuleList, p: int, mesh, *args):
    """``fn(period, *args)``; on a mesh, with period ``p``'s parameters
    gathered from their stored shards just before use."""
    if mesh is None:
        return fn(period, *args)
    return torch.func.functional_call(_Call(period, fn), mesh.period_params(p, period), args)


class _Gathered:
    """A model's leaves outside the periods (``embed``, ``lm_head``,
    ``media_proj``, ``final_norm``), each gathered on a mesh at its first
    use in a call, beside its config and periods."""

    def __init__(self, params: Transformer, mesh):
        self.cfg, self.periods = params.cfg, params.periods
        self._params, self._mesh = params, mesh

    def __getattr__(self, name: str):
        if name.startswith("_") or not hasattr(self._params, name):
            raise AttributeError(name)
        value = self._mesh.gather(name)
        setattr(self, name, value)
        return value


def forward(params: Transformer, tokens: torch.Tensor, *, media: torch.Tensor | None = None,
            return_cache: bool = False, mesh=None):
    """Full-sequence forward. Returns (hidden (B,S,D), aux, cache|None); the
    cache's leaves are stacked over periods on axis 0. ``media`` is
    projected by ``media_proj`` here (prefill's cross caches are
    projections of the projected media). With ``cfg.remat`` and grad
    enabled (and no caches asked for), each period runs under a
    non-reentrant checkpoint.

    ``mesh`` (a `sharding.spmd.MeshCompute`): run as one rank of a mesh on
    its tokens, each period's parameters gathered from their DTensor
    shards just before use (inside the checkpoint, so the backward
    gathers them again) and the MoE layers expert-parallel."""
    cfg = params.cfg
    dtype = _dtype(cfg)
    if mesh is not None and not isinstance(params, _Gathered):
        params = _Gathered(params, mesh)
    x = _embed(params, tokens, cfg, dtype)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    if media is not None and hasattr(params, "media_proj"):
        media = torch.einsum("bmd,de->bme", media.to(dtype), params.media_proj.to(dtype))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches: dict = {}
    remat = cfg.remat and torch.is_grad_enabled() and not return_cache
    for p, period in enumerate(params.periods):
        if remat:
            x, aux, _ = torch.utils.checkpoint.checkpoint(
                _on_period, _period_body, period, p, mesh, x, aux, positions, media, cfg, dtype,
                False, mesh, use_reentrant=False)
            continue
        x, aux, cs = _on_period(_period_body, period, p, mesh, x, aux, positions, media, cfg,
                                dtype, return_cache, mesh)
        for pos, c in cs.items():
            for name, leaf in c.items():
                stacked = caches.setdefault(pos, {})
                if name not in stacked:   # one buffer a leaf, stacked over periods
                    stacked[name] = torch.empty((cfg.n_periods, *leaf.shape), dtype=leaf.dtype,
                                                device=leaf.device)
                stacked[name][p] = leaf
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, aux / cfg.n_layers, (caches if return_cache else None)


def _lm_head(params: Transformer, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params.embed.T
    return params.lm_head


def loss_fn(params: Transformer, batch: dict, mesh=None) -> torch.Tensor:
    """Mean next-token CE (+ router aux): `chunked_cross_entropy` over
    ``cfg.loss_chunk`` tokens at a time against the head (tied or not, as
    `_lm_head` decides), cast to the hidden states' dtype; with codebooks
    the mean over the codebooks, each against its own head and labels.
    ``batch`` holds ``tokens``, ``labels`` (-1 = ignore) and, for vision
    models, ``media``. Each CE chunk is checkpointed when ``cfg.remat``.
    On a ``mesh`` (`forward`), the loss of this rank's tokens."""
    ce, aux = loss_terms(params, batch, mesh)
    return ce + params.cfg.router_aux_weight * aux


def label_counts(labels: torch.Tensor) -> torch.Tensor:
    """The count of labels >= 0 (one a codebook with codebooks), as fp32."""
    return (labels >= 0).sum(dim=(0, 1)).float()


def loss_terms(params: Transformer, batch: dict, mesh=None,
               n_labels: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """`loss_fn`'s (CE, router aux). ``n_labels`` (`label_counts` of the
    whole batch): the CE of this rank's tokens summed over that count, a
    rank's share of the batch's mean (`launch/train.py` on a mesh)."""
    cfg = params.cfg
    if mesh is not None:
        params = _Gathered(params, mesh)
    h, aux, _ = forward(params, batch["tokens"], media=batch.get("media"), mesh=mesh)
    labels = batch["labels"]
    if cfg.n_codebooks:
        ce = 0.0
        for q in range(cfg.n_codebooks):
            ce += L.chunked_cross_entropy(h, params.lm_head[q].to(h.dtype), labels[..., q],
                                          cfg.loss_chunk, remat=cfg.remat,
                                          n_labels=None if n_labels is None else n_labels[q])
        ce = ce / cfg.n_codebooks
    else:
        ce = L.chunked_cross_entropy(h, _lm_head(params, cfg).to(h.dtype), labels,
                                     cfg.loss_chunk, remat=cfg.remat, n_labels=n_labels)
    return ce, aux


def logits_of(params: Transformer, h: torch.Tensor) -> torch.Tensor:
    """Logits of hidden states h (B, S, D) in h's dtype: (B, S, vocab), or
    (B, S, n_q, vocab) with codebooks (``einsum("bsd,qdv->bsqv")``)."""
    head = _lm_head(params, params.cfg).to(h.dtype)
    if params.cfg.n_codebooks:
        return torch.einsum("bsd,qdv->bsqv", h, head)
    return torch.einsum("bsd,dv->bsv", h, head)


def prefill(params: Transformer, tokens: torch.Tensor, *, media: torch.Tensor | None = None,
            mesh=None):
    """Forward with caches; returns (last-position logits, cache). On a
    ``mesh`` (`forward`), this rank's tokens' logits and caches."""
    if mesh is not None:
        params = _Gathered(params, mesh)
    h, _, cache = forward(params, tokens, media=media, return_cache=True, mesh=mesh)
    return logits_of(params, h[:, -1:]), cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None, device="cuda") -> dict:
    """Empty fixed-size decode cache (leaves stacked over periods); a
    sliding-window layer keeps min(seq_len, window) slots (a ring)."""
    dev = device_lib.resolve(device)
    dtype = dtype or _dtype(cfg)
    np_, cache = cfg.n_periods, {}
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)
    for pos, spec in enumerate(cfg.period):
        if spec.kind == "attn":
            S_eff = min(seq_len, spec.sliding_window) if spec.sliding_window else seq_len
            if cfg.attn_type == "mla":
                c = {"ckv": z(np_, batch, S_eff, cfg.kv_lora_rank),
                     "kr": z(np_, batch, S_eff, cfg.rope_head_dim)}
            else:
                c = {"k": z(np_, batch, S_eff, cfg.n_kv_heads, cfg.head_dim),
                     "v": z(np_, batch, S_eff, cfg.n_kv_heads, cfg.v_head_dim)}
        elif spec.kind == "cross":
            c = {"mk": z(np_, batch, cfg.n_image_tokens, cfg.n_kv_heads, cfg.head_dim),
                 "mv": z(np_, batch, cfg.n_image_tokens, cfg.n_kv_heads, cfg.v_head_dim)}
        else:
            c = {"conv": z(np_, batch, cfg.ssm_conv_width - 1, ssm_lib.conv_dim(cfg)),
                 "state": z(np_, batch, cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_d_state,
                            dt=torch.float32)}
        cache[str(pos)] = c
    return cache


def _decode_mixer(lp: Layer, spec: LayerSpec, h, c: dict, p: int, pos: int, positions,
                  cfg: ModelConfig, dtype, mesh=None) -> torch.Tensor:
    """One layer's mixer output for one token, its cache entries written.

    On a ``mesh`` (a `MeshCompute`) the cache stays sharded: a
    self-attention cache whose positions lie over mesh axes is attended
    slice by slice (each rank over its positions, the partial softmaxes
    merged by all-reduces, `attention.merge_partials`) and the rank
    holding the new position writes it. SSM and cross-attention caches,
    and a KV cache sharded over its heads (positions that do not divide),
    are gathered for the period and this rank's block written back
    (`_positions_slice`, `_gathered_leaf`, `_write_back`; each the plain
    period without a mesh)."""
    m = None if mesh is None else mesh.mesh
    length = pos + 1
    if spec.kind == "attn" and cfg.attn_type == "mla":
        ckv_new, kr_new = attn_lib.mla_compress(lp.attn, h, positions, cfg, dtype)
        ckv, off, axes = _positions_slice(c["ckv"], m, p)
        kr = _local(c["kr"])[p]
        if off <= pos < off + ckv.shape[1]:
            ckv[:, pos - off] = ckv_new[:, 0]
            kr[:, pos - off] = kr_new[:, 0]
        return attn_lib.mla_decode(lp.attn, h, ckv, kr, length, positions, cfg, dtype,
                                   offset=off, merge=_merge(m, axes))
    if spec.kind == "attn":
        q, k, v = attn_lib.gqa_qkv(lp.attn, h, positions, cfg, dtype)
        slot, eff_len = _slot(spec, c["k"].shape[2], pos)
        if m is not None and _sharded_past_positions(c["k"]):
            kf, vf = _gathered_leaf(c["k"], m, p), _gathered_leaf(c["v"], m, p)
            kf[:, slot], vf[:, slot] = k[:, 0], v[:, 0]
            o = attn_lib.decode_attend(q[:, 0], kf, vf, eff_len)[:, None]
            _write_back(c["k"], m, p, kf)
            _write_back(c["v"], m, p, vf)
        else:
            kl, off, axes = _positions_slice(c["k"], m, p)
            vl = _local(c["v"])[p]
            if off <= slot < off + kl.shape[1]:
                kl[:, slot - off] = k[:, 0]
                vl[:, slot - off] = v[:, 0]
            o = attn_lib.decode_attend(q[:, 0], kl, vl, eff_len, offset=off,
                                       merge=_merge(m, axes))[:, None]
        return attn_lib.gqa_out(lp.attn, o, dtype)
    if spec.kind == "cross":
        mk, mv = _gathered_leaf(c["mk"], m, p), _gathered_leaf(c["mv"], m, p)
        q = torch.einsum("bsd,dhk->bshk", h, lp.attn.wq.to(dtype))[:, 0]
        o = attn_lib.decode_attend(q, mk, mv, mk.shape[1])[:, None]
        o = attn_lib.gqa_out(lp.attn, o, dtype)
        return torch.tanh(lp.attn.gate).to(dtype) * o
    conv, state = _gathered_leaf(c["conv"], m, p), _gathered_leaf(c["state"], m, p)
    o, ssm_c = ssm_lib.mamba_decode(lp.mamba, h, ssm_lib.SSMCache(conv=conv, state=state),
                                    cfg, dtype)
    _write_back(c["conv"], m, p, ssm_c.conv)
    _write_back(c["state"], m, p, ssm_c.state)
    return o


def _slot(spec: LayerSpec, buf: int, pos: int) -> tuple[int, int]:
    """(the cache slot position ``pos`` writes, the valid entries): a
    sliding-window ring writes slot pos mod window, every slot valid once
    wrapped (each entry lies within the window)."""
    if spec.sliding_window and spec.sliding_window <= buf:
        return pos % buf, min(pos + 1, buf)
    return pos, pos + 1


# --- the cache on a mesh (each helper the plain period when ``mesh`` is None) ----
def _local(x) -> torch.Tensor:
    return x.to_local() if hasattr(x, "to_local") else x


def _merge(mesh, axes):
    """`attention.merge_partials` over ``axes``, or None (no axes: the
    slice is the whole cache)."""
    return functools.partial(attn_lib.merge_partials, mesh=mesh, axes=axes) if axes else None


def _positions_slice(dt, mesh, p: int):
    """Period ``p`` of a self-attention cache leaf (a DTensor laid out by
    `launch/specs.py`): this rank's slice of the positions (dim 2), the
    slice's first position, and the mesh axes the positions lie over."""
    if mesh is None:
        return dt[p], 0, ()
    names, dims = spmd.axis_names(mesh), spmd.shard_dims(dt)
    axes = tuple(a for a, d in zip(names, dims) if d == 2)
    local = dt.to_local()[p]
    return local, spmd.coordinate(mesh, axes) * local.shape[1], axes


def _gathered_leaf(dt, mesh, p: int) -> torch.Tensor:
    """Period ``p`` of a cache leaf gathered over the axes that shard it
    past the batch (heads, channels); the batch stays this rank's."""
    if mesh is None:
        return dt[p]
    names, dims = spmd.axis_names(mesh), spmd.shard_dims(dt)
    x = dt.to_local()[p]
    for i in reversed(range(len(names))):
        if dims[i] is not None and dims[i] >= 2:
            x = spmd.all_gather(x, mesh, (names[i],), dim=dims[i] - 1)
    return x


def _write_back(dt, mesh, p: int, full: torch.Tensor) -> None:
    """This rank's block of ``full`` into period ``p`` of the stored leaf."""
    if mesh is not None:
        names, dims = spmd.axis_names(mesh), spmd.shard_dims(dt)
        for i, d in enumerate(dims):
            if d is not None and d >= 2:
                full = spmd.local_block(full, mesh, (names[i],), dim=d - 1)
    _local(dt)[p].copy_(full)


def _sharded_past_positions(dt) -> bool:
    return any(d is not None and d >= 3 for d in spmd.shard_dims(dt))


def _decode_period(period: nn.ModuleList, x, cache: dict, p: int, pos: int, positions,
                   cfg: ModelConfig, dtype, mesh):
    for lpos, spec in enumerate(cfg.period):
        lp, c = period[lpos], cache[str(lpos)]
        h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
        x = x + _decode_mixer(lp, spec, h, c, p, pos, positions, cfg, dtype, mesh)
        x, _ = _ffn(lp, spec, x, cfg, dtype, mesh)
    return x


def decode_step(params: Transformer, cache: dict, tokens: torch.Tensor, pos, mesh=None):
    """One decode step: tokens (B, 1) (or (B, 1, n_q)); ``pos`` (an int or a
    0-d tensor) the absolute position being written. Attends over pos+1
    cache entries (a sliding-window layer over its ring: slot pos % buf,
    min(pos+1, buf) entries). Writes the step's entries into ``cache`` in
    place; returns (logits, cache).

    On a ``mesh`` (`forward`): this rank's tokens, and a cache of DTensors
    laid out by `launch/specs.py::cache_specs`, written in place and never
    gathered (`_decode_mixer`)."""
    cfg = params.cfg
    dtype = _dtype(cfg)
    pos = int(pos)
    if mesh is not None:
        params = _Gathered(params, mesh)
    x = _embed(params, tokens, cfg, dtype)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    for p, period in enumerate(params.periods):
        x = _on_period(_decode_period, period, p, mesh, x, cache, p, pos, positions, cfg, dtype,
                       mesh)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_of(params, x), cache
