"""The mesh half's spec level in the port against the reference, on the
CPU and in this process (no spawn): the logical spec tree
(`transformer.param_specs`), `sharding/rules.py` (`resolve_spec`,
`params_pspecs`, the override tables), `launch/mesh.py`'s meshes,
`gossip.stacked_specs`, `serve.serve_param_shardings`,
`train._opt_shardings` and `launch/specs.py` (`batch_specs`,
`cache_specs`, `decode_specs`), each leaf for leaf against the
reference's on a `jax.sharding.AbstractMesh` (the ``(sizes, names)`` /
``((name, size), …)`` shim of `tests/test_sharding.py:19-22`), at full
width for every `ARCH_IDS` config and yi-34b-swa, on the (16, 16),
(2, 16, 16) and (2, 4) meshes. The reference tests' own cases
(`tests/test_sharding.py:12-45`, `tests/test_perf_variants.py:68-80`)
run on the port too.
"""
import functools

import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import optim as ref_optim  # noqa: E402
from repro.configs import registry as ref_registry  # noqa: E402
from repro.core import gossip as ref_gossip  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models import config as ref_mc  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.sharding import rules as ref_rules  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import gossip  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import serve, specs  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import config as mc  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.utils import tree as tree_lib  # noqa: E402

ARCHS = [*registry.ARCH_IDS, "yi-34b-swa"]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
DTYPES = {"int32": torch.int32, "float32": torch.float32, "bfloat16": torch.bfloat16}


def ref_abstract(sizes, names):
    try:
        return AbstractMesh(tuple(zip(names, sizes)))
    except TypeError:
        return AbstractMesh(sizes, names)


def meshes(key):
    sizes, names = MESHES[key]
    return ref_abstract(sizes, names), mesh_lib.MeshShape(names, sizes)


@functools.cache
def ref_params(arch):
    return ref_tf.abstract_params(ref_registry.get_config(arch))


def flat(tree, is_leaf):
    """{'/'-joined path: leaf} of a reference tree."""
    pairs, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    key = lambda k: getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))
    return {"/".join(str(key(k)) for k in path): leaf
            for path, leaf in pairs}


def spec_leaf(s):
    return isinstance(s, tuple) and all(isinstance(x, str) or x is None for x in s)


def jp_leaf(s):
    return isinstance(s, JP)


def port_flat(tree):
    return dict(rules.spec_paths(tree))


def same_specs(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for path in want:
        assert tuple(got[path]) == tuple(want[path]), (path, got[path], want[path])


# ---------------------------------------------------------------------------
# the logical spec tree and params_pspecs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference_tree(arch):
    _, ref = ref_params(arch)
    got = transformer.param_specs(registry.get_config(arch))
    same_specs(port_flat(got), flat(ref, spec_leaf))
    shapes = {p: tuple(t.shape) for p, t in
              tree_lib.tree_paths(transformer.param_shapes(registry.get_config(arch)))}
    ref_shapes = {p: tuple(x.shape) for p, x in flat(ref_params(arch)[0], None).items()}
    assert shapes == ref_shapes


@pytest.mark.parametrize("variant", ["fsdp", "no_fsdp", "dp"])
@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_params_pspecs_equal_reference(arch, mesh_key, variant):
    ref_m, m = meshes(mesh_key)
    shape, spec = ref_params(arch)
    kw = {"fsdp": variant != "no_fsdp",
          "overrides": rules.DP_OVERRIDES if variant == "dp" else None}
    want = ref_rules.params_pspecs(spec, shape, ref_m, **kw)
    cfg = registry.get_config(arch)
    got = rules.params_pspecs(transformer.param_specs(cfg), transformer.param_shapes(cfg), m, **kw)
    same_specs(port_flat(got), flat(want, jp_leaf))


@pytest.mark.parametrize("axis", ["data", "pod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_specs_equal_reference(arch, axis):
    ref_m, m = meshes("2x16x16")
    shape, spec = ref_params(arch)
    L = 2 if axis == "pod" else 16
    st_ref = ref_gossip.stacked_specs(spec, axis)
    st = gossip.stacked_specs(transformer.param_specs(registry.get_config(arch)), axis)
    same_specs(port_flat(st), flat(st_ref, spec_leaf))
    stacked_shape = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct((L, *x.shape), x.dtype), shape)
    want = ref_rules.params_pspecs(st_ref, stacked_shape, ref_m, fsdp=axis != "data")
    got = rules.params_pspecs(st, transformer.param_shapes(registry.get_config(arch), lead=(L,)),
                              m, fsdp=axis != "data")
    same_specs(port_flat(got), flat(want, jp_leaf))


@pytest.mark.parametrize("ws", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_param_shardings_equal_reference(arch, ws):
    ref_m, m = meshes("16x16")
    want = ref_serve.serve_param_shardings(ref_registry.get_config(arch), ref_m, fsdp=not ws,
                                           weight_stationary=ws)
    want = jax.tree_util.tree_map(lambda s: s.spec, want,
                                  is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    got = serve.serve_param_shardings(registry.get_config(arch), m, fsdp=not ws,
                                      weight_stationary=ws)
    same_specs(port_flat(got), flat(want, jp_leaf))


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_shardings_equal_reference(arch):
    ref_m, m = meshes("16x16")
    shape, spec = ref_params(arch)
    pspecs = ref_rules.params_pspecs(spec, shape, ref_m)
    pshard = jax.tree_util.tree_map(lambda s: jax.sharding.NamedSharding(ref_m, s), pspecs,
                                    is_leaf=jp_leaf)
    want = ref_train._opt_shardings(ref_optim.adamw(3e-4), shape, pshard)
    want = flat(jax.tree_util.tree_map(lambda s: s.spec, want), jp_leaf)
    cfg = registry.get_config(arch)
    port_pspecs = rules.params_pspecs(transformer.param_specs(cfg), transformer.param_shapes(cfg), m)
    got = train._opt_shardings(optim.adamw(3e-4), transformer.param_shapes(cfg), port_pspecs)
    got_flat = {"step": got.step,
                **{f"inner/mu/{p}": v for p, v in port_flat(got.inner.mu).items()},
                **{f"inner/nu/{p}": v for p, v in port_flat(got.inner.nu).items()}}
    same_specs(got_flat, want)


# ---------------------------------------------------------------------------
# the input stand-ins
# ---------------------------------------------------------------------------
def sds_flat(tree):
    leaves = flat(tree, lambda x: isinstance(x, jax.ShapeDtypeStruct))
    return {p: (tuple(x.shape), str(x.dtype), tuple(x.sharding.spec)) for p, x in leaves.items()}


def meta_flat(tree, spec_tree):
    s = port_flat(spec_tree)
    return {p: (tuple(x.shape), {v: k for k, v in DTYPES.items()}[x.dtype], tuple(s[p]))
            for p, x in tree_lib.tree_paths(tree)}


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("shape_name", list(mc.INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch, shape_name, mesh_key):
    ref_m, m = meshes(mesh_key)
    ref_cfg, cfg = ref_registry.get_config(arch), registry.get_config(arch)
    ref_shape, shape = ref_mc.INPUT_SHAPES[shape_name], mc.INPUT_SHAPES[shape_name]
    if shape.kind in ("train", "prefill"):
        assert meta_flat(*specs.batch_specs(cfg, shape, m)) == sds_flat(
            ref_specs.batch_specs(ref_cfg, ref_shape, ref_m))
        return
    ref_cache, ref_cps = ref_specs.cache_specs(ref_cfg, ref_shape, ref_m)
    cache, cps = specs.cache_specs(cfg, shape, m)
    assert meta_flat(cache, cps) == sds_flat(ref_cache)
    same_specs(port_flat(cps), flat(ref_cps, jp_leaf))
    r_cache, r_cps, r_tok, r_pos = ref_specs.decode_specs(ref_cfg, ref_shape, ref_m)
    d = specs.decode_specs(cfg, shape, m)
    assert meta_flat(d.cache, d.cache_pspecs) == sds_flat(r_cache)
    assert (tuple(d.tokens.shape), tuple(d.tokens_spec)) == (r_tok.shape, tuple(r_tok.sharding.spec))
    assert (tuple(d.pos.shape), tuple(d.pos_spec)) == (r_pos.shape, tuple(r_pos.sharding.spec))
    assert d.tokens.dtype == torch.int32 and str(r_tok.dtype) == "int32"


# ---------------------------------------------------------------------------
# the reference tests' own cases, on the port
# ---------------------------------------------------------------------------
CASES = [  # tests/test_sharding.py:12-35 and tests/test_perf_variants.py:68-80
    ((2, 16), ("embed", "heads", None), (64, 56, 16), None, ("data", None, None)),
    ((2, 16), ("embed", "heads", None), (64, 32, 16), None, ("data", "model", None)),
    ((2, 16), ("vocab", "embed_nodiv"), (1000, 63), None, (None, None)),
    ((2, 16), ("vocab", "embed_nodiv"), (1024, 63), None, ("model", None)),
    ((2, 16), ("__mesh__data", "ff"), (2, 64), None, ("data", "model")),
    ((2, 4), ("experts", "embed", "expert_ff"), (8, 64, 32), "ws", ("model", None, "data")),
    ((2, 4), ("embed", "heads", None), (64, 8, 16), "ws", (None, "model", None)),
]


@pytest.mark.parametrize("sizes,logical,shape,over,want", CASES)
def test_resolve_spec_reference_cases(sizes, logical, shape, over, want):
    m = mesh_lib.MeshShape(("data", "model"), sizes)
    overrides = rules.SERVE_WS_OVERRIDES if over == "ws" else None
    got = rules.resolve_spec(logical, shape, m, overrides=overrides)
    assert got == rules.P(*want) and tuple(got) == want
    ref = ref_rules.resolve_spec(logical, shape, ref_abstract(sizes, ("data", "model")),
                                 overrides=ref_rules.SERVE_WS_OVERRIDES if over else None)
    assert tuple(ref) == want
    assert repr(got) == repr(ref)


def test_rule_tables_equal_reference():
    assert rules.LOGICAL_RULES == ref_rules.LOGICAL_RULES
    assert rules.DP_OVERRIDES == ref_rules.DP_OVERRIDES
    assert rules.SERVE_WS_OVERRIDES == ref_rules.SERVE_WS_OVERRIDES


@pytest.mark.parametrize("multi_pod", [False, True])
def test_meshes_and_batch_axes(multi_pod):
    m = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    assert m.sizes == ((2, 16, 16) if multi_pod else (16, 16))
    assert m.axis_names == (("pod", "data", "model") if multi_pod else ("data", "model"))
    assert m.size == (512 if multi_pod else 256)
    assert mesh_lib.batch_axes(m) == (("pod", "data") if multi_pod else ("data",))
    assert mesh_lib.n_batch_shards(m) == (32 if multi_pod else 16)
    t = mesh_lib.make_test_mesh(2, 4, multi_pod=multi_pod)
    r = ref_abstract((2, 2, 4) if multi_pod else (2, 4), t.axis_names)
    assert t.shape == dict(r.shape)
    assert mesh_lib.batch_axes(t) == ref_mesh.batch_axes(r)
    assert mesh_lib.n_batch_shards(t) == ref_mesh.n_batch_shards(r)


def test_device_mesh_refuses_a_group_of_another_size():
    with pytest.raises(RuntimeError, match="initialised process group"):
        mesh_lib.device_mesh(mesh_lib.make_test_mesh(2, 2), "cpu")


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    m = mesh_lib.MeshShape(("pod", "data", "model"), (2, 2, 2))
    assert rules.placements(rules.P(("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert rules.placements(rules.P(None, None), m) == (Replicate(),) * 3
    tree = rules.params_placements({"a": ("embed", "ff")}, {"a": torch.empty(4, 6, device="meta")},
                                   m)
    assert tree["a"].placements == (Replicate(), Shard(0), Shard(1))
