"""Rank functions for tests/test_torch_mesh_steps.py: one 4-rank gloo group
on the CPU builds the (2, 2), (4, 1) and (1, 4) meshes and runs the mesh
half's holds (no JAX import here: the reference's outputs arrive as numpy
arrays). Every rank runs the same program; rank 0's findings go back."""
from __future__ import annotations

import dataclasses
import types

import torch

SEQ, BATCH, STEPS = 16, 4, 3
DECODE_PROMPT, DECODE_STEPS = 8, 4
SERVE_CASES = (("qwen1.5-4b", "1x4", 2), ("qwen1.5-4b", "2x2", 1),
               ("deepseek-v2-lite-16b", "1x4", 2), ("yi-34b-swa", "1x4", 2),
               ("jamba-1.5-large-398b", "2x2", 2))


def _meshes(device: str = "cpu"):
    from repro_torch.launch import mesh as mesh_lib
    return {name: mesh_lib.device_mesh(mesh_lib.MeshShape(("data", "model"), sizes), device)
            for name, sizes in (("2x2", (2, 2)), ("4x1", (4, 1)), ("1x4", (1, 4)))}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _full(dt) -> torch.Tensor:
    """A DTensor gathered to the whole tensor (every rank calls it)."""
    from repro_torch.sharding import spmd
    with torch.no_grad():
        return spmd.gather(dt, tuple(spmd.REPLICATE for _ in dt.placements))


# ---------------------------------------------------------------------------
def _moe(mesh, cfg_kw: dict, arrays: dict) -> dict:
    """moe_ffn_sharded, expert parallel and weight-stationary, B=4 and 1,
    on the reference's numpy params and tokens; outputs gathered."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe
    from repro_torch.models.config import LayerSpec, ModelConfig
    from repro_torch.sharding import rules, spmd
    cfg = ModelConfig(**cfg_kw, period=(LayerSpec(kind="attn", moe=True),))
    specs = moe.moe_specs(cfg)
    out = {}
    for ws in (False, True):
        over = rules.SERVE_WS_OVERRIDES if ws else None
        p = types.SimpleNamespace()
        for name, spec in specs.items():
            full = torch.from_numpy(arrays[name])
            if name in ("wi", "wg", "wo"):
                ps = rules.resolve_spec(spec, full.shape, mesh, overrides=over)
                setattr(p, name, spmd.distribute(full, mesh, rules.placements(ps, mesh)))
            else:
                setattr(p, name, full)
        for B in (4, 1):
            x = torch.from_numpy(arrays[f"x{B}"])
            n = mesh_lib.n_batch_shards(mesh)
            place = tuple(Shard(0) if (a != "model" and B % n == 0) else Replicate()
                          for a in mesh.mesh_dim_names)
            local = spmd.local_block(x, mesh, ("data",)) if B % n == 0 else x
            xd = DTensor.from_local(local, mesh, place, run_check=False)
            with torch.no_grad():
                y, aux = moe.moe_ffn_sharded(p, xd, cfg, torch.float32, mesh, weight_stationary=ws)
                out[f"{'ws' if ws else 'ep'}_B{B}"] = (_full(y).numpy(), float(aux))
    return out


# ---------------------------------------------------------------------------
def _data(cfg, seed: int = 0):
    from repro_torch.data.lm_pipeline import LMDataConfig, SyntheticLM
    return SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, batch_size=BATCH,
                                    seed=seed))


def _masked(batch: dict) -> dict:
    """``batch`` with the labels of its second half (the second data
    shard's rows) ignored at 10 of their 16 positions."""
    labels = batch["labels"].copy()
    labels[BATCH // 2:, :10] = -1
    return {**batch, "labels": labels}


def _allreduce(mesh, arch: str, overrides=None, masked: bool = False, device: str = "cpu") -> dict:
    """3 ``allreduce`` mesh steps against the port's one-device step, from
    the same model and batches (``masked``: ignored labels on one batch
    shard only); losses, every parameter, bytes a rank."""
    from repro_torch import optim
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.models import config as mc
    from repro_torch.models import transformer
    from repro_torch.sharding import rules
    cfg = mc.reduced(registry.get_config(arch))
    opt = optim.adamw(3e-3, eps=1e-3)
    step, init = train.make_train_step(cfg, opt, device=device, mesh=mesh,
                                       rules_overrides=overrides)
    state = init(model=transformer.init_params(cfg, 0, device=device))
    ref_step, ref_init = train.make_train_step(cfg, opt, device=device)
    ref = ref_init(0)
    data = _data(cfg)
    losses = []
    for i in range(STEPS):
        batch = _masked(data.batch(i)) if masked else data.batch(i)
        state, m = step(state, batch)
        ref, rm = ref_step(ref, batch)
        losses.append((float(m["loss"]), float(rm["loss"])))
    want = dict(ref.params.named_parameters())
    param_rel = max(_rel(_full(p), want[n]) for n, p in state.params.named_parameters())
    # the state's bytes on this rank against the specs' analytic count
    pspecs = rules.params_pspecs(transformer.param_specs(cfg), transformer.param_shapes(cfg), mesh,
                                 overrides=overrides)
    # parameters and both moments (the gradients are freed after a step) and the int32 step
    analytic = 3 * rules.local_bytes(pspecs, transformer.param_shapes(cfg), mesh) + 4
    return {"losses": losses, "param_rel": param_rel,
            "state_bytes": train.state_bytes(state), "analytic_bytes": analytic}


def _one_device_norm(grads, mesh, axes, stacked: bool = False) -> torch.Tensor:
    """`train._logical_norm` summed as the one-device gossip step sums it:
    each gradient gathered whole over ``axes``, its periods stacked, the
    squares of each contiguous leaf summed in `named_leaves` order."""
    from repro_torch.launch import train
    from repro_torch.sharding import spmd
    terms = []
    with torch.no_grad():
        for _, leaf in train._path_groups(grads):
            full = [spmd.gather(g, tuple(spmd.REPLICATE if a in axes else spmd.KEEP
                                         for a in mesh.mesh_dim_names))[0]
                    for g in (leaf if isinstance(leaf, list) else [leaf])]
            x = (torch.stack(full) if isinstance(leaf, list) else full[0]).contiguous()
            terms.append(torch.sum(torch.square(x.float())))
    return torch.sqrt(sum(terms))


def _gossip(mesh, L: int, one_device_norm: bool = False, device: str = "cpu") -> dict:
    """3 gossip mesh steps (learners along ``data``) against the
    one-device gossip step at the same L; ``one_device_norm``: the
    clipping norm summed in the one-device order (`_one_device_norm`)."""
    from repro_torch.launch import train
    own = train._logical_norm
    if one_device_norm:
        train._logical_norm = _one_device_norm
    try:
        return _gossip_steps(mesh, L, device)
    finally:
        train._logical_norm = own


def _gossip_steps(mesh, L: int, device: str) -> dict:
    from repro_torch import optim
    from repro_torch.configs import registry
    from repro_torch.core.gossip import GossipConfig
    from repro_torch.launch import train
    from repro_torch.models import config as mc
    from repro_torch.models import transformer
    from repro_torch.optim.optimizers import named_leaves
    cfg = mc.reduced(registry.get_config("qwen1.5-4b"))
    gcfg = GossipConfig(learner_axis="data", walk_length=2)
    opt = optim.adamw(3e-3, eps=1e-3)
    step, init = train.make_train_step(cfg, opt, sync="gossip", gossip=gcfg, device=device,
                                       mesh=mesh)
    state = init(model=transformer.init_params(cfg, 0, device=device))
    ref_step, ref_init = train.make_train_step(cfg, opt, sync="gossip", gossip=gcfg,
                                               n_learners=L, device=device)
    ref = ref_init(0)
    data = _data(cfg, seed=1)
    rows = []
    for i in range(STEPS):
        state, m = step(state, data.batch(i))
        ref, rm = ref_step(ref, data.batch(i))
        rows.append((float(m["loss"]), float(rm["loss"]), float(m["consensus_err"]),
                     float(rm["consensus_err"])))
    me = mesh.get_local_rank("data")
    want = dict(named_leaves(ref.params))
    seen: dict = {}
    param_rel, bitwise = 0.0, True
    for path, p in named_leaves(state.params):
        k = seen.get(path, 0)
        seen[path] = k + 1
        got = _full(p)[me]
        w = want[path][me][k] if path.startswith("blocks/") else want[path][me]
        param_rel = max(param_rel, _rel(got, w))
        bitwise &= bool(torch.equal(got, w))
    return {"rows": rows, "param_rel": param_rel, "bitwise": bitwise}


# ---------------------------------------------------------------------------
def _serve(mesh, arch: str, B: int, device: str = "cpu") -> dict:
    """Prefill then decode on a cache sharded as `cache_specs` says,
    against the one-device prefill and decode of the same model."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve, specs
    from repro_torch.models import config as mc
    from repro_torch.models import transformer
    from repro_torch.models.config import InputShape
    cfg = mc.reduced(registry.get_config(arch))
    if cfg.n_routed_experts:     # no capacity drops: a batch split changes which routes drop
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_routed_experts / cfg.moe_top_k)
    if any(s.sliding_window for s in cfg.period):   # a ring shorter than prompt + decode
        cfg = dataclasses.replace(cfg, period=tuple(
            dataclasses.replace(s, sliding_window=8) for s in cfg.period))
    total = DECODE_PROMPT + DECODE_STEPS
    gen = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, DECODE_PROMPT), generator=gen)
             .to(device)}
    ref_model = transformer.init_params(cfg, 0, device=device)
    model = serve.shard_for_serving(transformer.init_params(cfg, 0, device=device), mesh)
    _, cps = specs.cache_specs(cfg, InputShape("decode", total, B, "decode"), mesh)
    logits, pc = serve.make_prefill_step(cfg, device=device, mesh=mesh)(model, batch)
    cache = serve.cache_from_prefill(cfg, pc, total, device=device, mesh=mesh, cache_pspecs=cps)
    ref_logits, rpc = serve.make_prefill_step(cfg, device=device)(ref_model, batch)
    ref_cache = serve.cache_from_prefill(cfg, rpc, total, device=device)
    worst = _rel(logits.full_tensor(), ref_logits)
    decode = serve.make_decode_step(cfg, device=device, mesh=mesh, cache_pspecs=cps)
    ref_decode = serve.make_decode_step(cfg, device=device)
    nxt, same_ids = ref_logits.argmax(-1), True
    for i in range(DECODE_STEPS):
        logits, cache = decode(model, cache, nxt, DECODE_PROMPT + i)
        ref_logits, ref_cache = ref_decode(ref_model, ref_cache, nxt, DECODE_PROMPT + i)
        full = logits.full_tensor()
        worst = max(worst, _rel(full, ref_logits))
        same_ids &= bool(torch.equal(full.argmax(-1).cpu(), ref_logits.argmax(-1).cpu()))
        nxt = ref_logits.argmax(-1)
    cache_rel = max(_rel(cache[pos][k].full_tensor(), ref_cache[pos][k])
                    for pos in cache for k in cache[pos])
    seq_sharded = [str(tuple(s)) for leaves in cps.values() for s in leaves.values()]
    return {"logits_rel": worst, "same_ids": same_ids, "cache_rel": cache_rel,
            "cache_specs": seq_sharded}


def mesh_case(rank: int, moe_cfg: dict, moe_arrays: dict) -> dict:
    torch.set_num_threads(1)
    meshes = _meshes()
    out = {"moe": _moe(meshes["2x2"], moe_cfg, moe_arrays)}
    from repro_torch.sharding import rules
    out["allreduce_2x2"] = _allreduce(meshes["2x2"], "qwen1.5-4b")
    out["allreduce_dp_2x2"] = _allreduce(meshes["2x2"], "qwen1.5-4b", rules.DP_OVERRIDES)
    out["allreduce_masked_2x2"] = _allreduce(meshes["2x2"], "qwen1.5-4b", masked=True)
    out["allreduce_moe_1x4"] = _allreduce(meshes["1x4"], "deepseek-v2-lite-16b")
    out["gossip_4x1"] = _gossip(meshes["4x1"], 4)
    out["gossip_2x2"] = _gossip(meshes["2x2"], 2)
    out["gossip_2x2_one_device_norm"] = _gossip(meshes["2x2"], 2, one_device_norm=True)
    for arch, mesh, B in SERVE_CASES:
        out[f"serve_{arch}_{mesh}_B{B}"] = _serve(meshes[mesh], arch, B)
    return out


def card_case(rank: int, device: str = "cuda") -> dict:
    """On one card, a one-rank nccl group: the ``allreduce`` mesh step on a
    1×1 mesh against the one-device step (3 steps), and `moe_ffn_sharded`
    at D=1 against `moe_ffn_local` on the same tokens (the batch Shard(0)
    over the one-wide ``data`` axis, as `launch/specs.py` lays it out)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.configs import registry
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import config as mc
    from repro_torch.models import moe, transformer
    from repro_torch.sharding import spmd
    m = mesh_lib.device_mesh(mesh_lib.MeshShape(("data", "model"), (1, 1)), device)
    out = {"allreduce_1x1": _allreduce(m, "qwen1.5-4b", device=device)}
    cfg = mc.reduced(registry.get_config("deepseek-v2-lite-16b"))
    layer = transformer.init_params(cfg, 0, device=device).periods[0][0].moe
    x = torch.randn((4, 16, cfg.d_model), generator=torch.Generator(device).manual_seed(0),
                    device=device)
    with torch.no_grad():
        want, want_aux = moe.moe_ffn_local(layer, x, cfg, torch.float32)
        p = types.SimpleNamespace(**{n: t for n, t in layer.named_parameters()})
        for n in ("wi", "wg", "wo"):
            setattr(p, n, spmd.distribute(getattr(layer, n), m, (Replicate(), Replicate())))
        xd = DTensor.from_local(x, m, (Shard(0), Replicate()), run_check=False)
        got, aux = moe.moe_ffn_sharded(p, xd, cfg, torch.float32, m)
    out["moe_d1"] = {"rel": _rel(got.to_local(), want),
                     "aux_rel": abs(float(aux) - float(want_aux)) / abs(float(want_aux))}
    return out


def _moe_vs_local(mesh, cfg_kw: dict, device: str, ws: bool) -> dict:
    """`moe_ffn_sharded` (``ws``: weight-stationary), B=4 and 1, against
    `moe_ffn_local` on the same layer and tokens (the card's counterpart
    of `_moe`, whose reference is the JAX package's). On a mesh whose
    batch axes split the tokens each shard routes, drops and averages its
    aux on its own, as the reference does, so ``mesh`` holds every token
    on each rank (expert parallel on (1, 4); weight-stationary gathers
    them)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe
    from repro_torch.models.config import LayerSpec, ModelConfig
    from repro_torch.sharding import rules, spmd
    cfg = ModelConfig(**cfg_kw, period=(LayerSpec(kind="attn", moe=True),))
    layer = moe.MoE(cfg, generator=torch.Generator(device).manual_seed(0), device=device)
    over = rules.SERVE_WS_OVERRIDES if ws else None
    p = types.SimpleNamespace(**{n: t.detach() for n, t in layer.named_parameters()})
    for n in ("wi", "wg", "wo"):
        ps = rules.resolve_spec(moe.moe_specs(cfg)[n], tuple(getattr(layer, n).shape), mesh,
                                overrides=over)
        setattr(p, n, spmd.distribute(getattr(layer, n), mesh, rules.placements(ps, mesh)))
    out = {}
    for B in (4, 1):
        x = torch.randn((B, 16, cfg.d_model), generator=torch.Generator(device).manual_seed(B),
                        device=device)
        split = B % mesh_lib.n_batch_shards(mesh) == 0
        place = tuple(Shard(0) if (a != "model" and split) else Replicate()
                      for a in mesh.mesh_dim_names)
        local = spmd.local_block(x, mesh, ("data",)) if split else x
        xd = DTensor.from_local(local, mesh, place, run_check=False)
        with torch.no_grad():
            want, want_aux = moe.moe_ffn_local(layer, x, cfg, torch.float32)
            y, aux = moe.moe_ffn_sharded(p, xd, cfg, torch.float32, mesh, weight_stationary=ws)
            out[f"{'ws' if ws else 'ep'}_B{B}"] = {
                "rel": _rel(_full(y), want),
                "aux_rel": abs(float(aux) - float(want_aux)) / abs(float(want_aux))}
    return out



def four_card_case(rank: int, moe_cfg: dict, device: str = "cuda") -> dict:
    """Four nccl ranks, one a card: `mesh_case`'s holds with every
    collective NCCL's (all-gathers, reduce-scatters, all-reduces and the
    gossip ring's sends), `moe_ffn_sharded` held against `moe_ffn_local`
    on the card; fp32 with TF32 off."""
    from repro_torch.sharding import rules
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    meshes = _meshes(device)
    out = {"moe": _moe_vs_local(meshes["1x4"], moe_cfg, device, ws=False)
           | _moe_vs_local(meshes["2x2"], moe_cfg, device, ws=True)}
    out["allreduce_2x2"] = _allreduce(meshes["2x2"], "qwen1.5-4b", device=device)
    out["allreduce_dp_2x2"] = _allreduce(meshes["2x2"], "qwen1.5-4b", rules.DP_OVERRIDES,
                                         device=device)
    out["allreduce_masked_2x2"] = _allreduce(meshes["2x2"], "qwen1.5-4b", masked=True,
                                             device=device)
    out["allreduce_moe_1x4"] = _allreduce(meshes["1x4"], "deepseek-v2-lite-16b", device=device)
    out["gossip_4x1"] = _gossip(meshes["4x1"], 4, device=device)
    out["gossip_2x2"] = _gossip(meshes["2x2"], 2, device=device)
    for arch, mesh, B in SERVE_CASES:
        out[f"serve_{arch}_{mesh}_B{B}"] = _serve(meshes[mesh], arch, B, device=device)
    return out

