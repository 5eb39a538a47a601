"""The port's dry run (`python -m repro_torch.launch.dryrun`) on a fake
8-rank (2, 4) group, on the three reduced configs of
`tests/test_sharding.py:62-66`, for train and decode (``--small``), and
one gossip train record. Each runs in a subprocess (the fake group is a
process's default group). Checked: every combination writes a record;
the argument bytes equal the analytic sum of the rank's local shards from
the reference's `params_pspecs` (on a `jax.sharding.AbstractMesh`), the
state's moments and step and its batch rows, or the decode cache's from
the reference's `cache_specs`; FSDP's all-gathers and gossip's sends
appear with nonzero bytes; a dense config's FLOPs lie within 5% of an
analytic matmul count.

A full-width record (qwen1.5-4b ``train_4k`` on the fake (16, 16) group)
takes ~60 s of fake-tensor dispatch on this CPU, twice the 30 s this
file allows it, so it runs from the command line only
(`python -m repro_torch.launch.dryrun --arch qwen1.5-4b --shape train_4k`).

The reference's `tests/test_dryrun_parse.py` holds its parser of XLA's
HLO text, which has no counterpart here: the port counts collectives at
dispatch, not in compiled text.
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.models import config as ref_mc  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.sharding import rules as ref_rules  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
COMBOS = [(a, s) for a in dryrun.SMALL for s in dryrun.SMALL_SHAPES]


def ref_mesh():
    try:
        return AbstractMesh((("data", 2), ("model", 4)))
    except TypeError:
        return AbstractMesh((2, 4), ("data", "model"))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    for extra in ([], ["--sync", "gossip", "--arch", "minitron-4b", "--shape", "train"]):
        res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--small",
                              "--out", str(out), *extra],
                             capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return {p.stem: json.loads(p.read_text()) for p in out.glob("*.json")}


def ref_cfg(arch):
    return ref_mc.reduced(ref_registry.get_config(arch), **dryrun.SMALL[arch])


def local_bytes(tree, specs, mesh) -> int:
    """Σ leaf bytes / the product of the mesh axes its spec names."""
    leaves = jax.tree_util.tree_leaves(tree)
    specs = jax.tree_util.tree_leaves(specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    total = 0
    for x, s in zip(leaves, specs):
        n = 1
        for e in s:
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                n *= mesh.shape[a]
        total += math.prod(x.shape) * np.dtype(x.dtype).itemsize // n
    return total


@pytest.mark.parametrize("arch,kind", COMBOS)
def test_every_combination_writes_a_record(records, arch, kind):
    rec = records[f"{arch}__{kind}__2x4__allreduce"]
    assert "error" not in rec, rec.get("error")
    assert rec["n_devices"] == 8 and rec["mesh"] == "2x4"
    assert rec["hlo_flops_per_device"] > 0 and rec["corrected_flops_per_device"] == rec[
        "hlo_flops_per_device"]
    assert rec["collective_bytes_per_device"] == rec["corrected_collective_bytes_per_device"]


@pytest.mark.parametrize("arch,kind", COMBOS)
def test_argument_bytes_equal_the_analytic_count(records, arch, kind):
    rec = records[f"{arch}__{kind}__2x4__allreduce"]
    mesh = ref_mesh()
    cfg = ref_cfg(arch)
    shape, spec = ref_tf.abstract_params(cfg)
    shp = dryrun.SMALL_SHAPES[kind]
    if kind == "train":
        params = local_bytes(shape, ref_rules.params_pspecs(spec, shape, mesh), mesh)
        rows = shp.global_batch // 2 * shp.seq_len * 4 * 2      # tokens + labels, int32
        want = 3 * params + 4 + rows                          # params, mu, nu, the step
    else:
        params = local_bytes(shape, ref_rules.params_pspecs(spec, shape, mesh), mesh)
        ishape = ref_mc.InputShape(shp.name, shp.seq_len, shp.global_batch, shp.kind)
        cache, cps = ref_specs.cache_specs(cfg, ishape, mesh)
        want = params + local_bytes(cache, cps, mesh) + shp.global_batch // 2 * 4
    assert rec["param_bytes_per_device"] == params
    assert rec["argument_size_bytes"] == want


def test_fsdp_gathers_and_gossip_sends_have_bytes(records):
    train = records["minitron-4b__train__2x4__allreduce"]["collective_bytes_per_device"]
    assert train["all-gather"] > 0 and train["reduce-scatter"] > 0
    gossip = records["minitron-4b__train__2x4__gossip"]["collective_bytes_per_device"]
    assert gossip["collective-permute"] > 0


def test_dense_flops_match_an_analytic_matmul_count(records):
    """minitron at (2, 4): each rank's 4 rows of 256 tokens through every
    matmul (the model axis computes the dense layers redundantly), dense
    attention tiles (S ≤ the chunk), forward + backward (no remat)."""
    cfg = ref_cfg("minitron-4b")
    shp = dryrun.SMALL_SHAPES["train"]
    B, S = shp.global_batch // 2, shp.seq_len
    d, H, KV, hd, F, V = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size
    per_layer = d * H * hd * 2 + d * KV * hd * 2 + 3 * d * F
    fwd = 2 * B * S * (cfg.n_layers * per_layer + d * V) + cfg.n_layers * 4 * B * S * S * H * hd
    assert not cfg.remat
    got = records["minitron-4b__train__2x4__allreduce"]["hlo_flops_per_device"]
    assert abs(got - 3 * fwd) <= 0.05 * 3 * fwd, (got, 3 * fwd)
