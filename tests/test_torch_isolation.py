"""The port stands alone: `repro_torch` imports neither `jax` nor `repro`
nor `ml_dtypes` (a JAX dependency the card's machine lacks), and its entry
points run on the card unless the caller asks for the CPU."""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import device as device_lib
from repro_torch.core import dmf, graph
from repro_torch.launch import dmf_train
from repro_torch.serving import (ServingEngine, SyntheticFactors, TiledFactorStore,
                                 build_candidate_index, store_from_numpy)

PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "new = {'repro_torch.checkpoint.ckpt', 'repro_torch.robustness.faults',\n"
        "       'repro_torch.robustness.byzantine', 'repro_torch.robustness.recovery',\n"
        "       'repro_torch.privacy.audit', 'repro_torch.obs.trace',\n"
        "       'repro_torch.obs.telemetry', 'repro_torch.scheduling.workload',\n"
        "       'repro_torch.scheduling.metrics', 'repro_torch.scheduling.scheduler',\n"
        "       'repro_torch.sharding.dmf', 'repro_torch.launch.mesh',\n"
        "       'repro_torch.examples.quickstart', 'repro_torch.examples.poi_serving',\n"
        "       'repro_torch.models.config', 'repro_torch.models.layers',\n"
        "       'repro_torch.models.attention', 'repro_torch.models.ssm',\n"
        "       'repro_torch.models.moe', 'repro_torch.models.transformer',\n"
        "       'repro_torch.utils.tree', 'repro_torch.launch.serve',\n"
        "       'repro_torch.configs.registry', 'repro_torch.configs.yi_34b_swa',\n"
        "       'repro_torch.configs.qwen1_5_4b', 'repro_torch.configs.jamba_1_5_large_398b',\n"
        "       'repro_torch.data.lm_pipeline', 'repro_torch.optim',\n"
        "       'repro_torch.optim.optimizers', 'repro_torch.optim.schedules',\n"
        "       'repro_torch.core.gossip', 'repro_torch.launch.train',\n"
        "       'repro_torch.examples.train_lm', 'repro_torch.examples.decentralized_lm'}\n"
        "assert new <= set(names), new - set(names)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro',\n"
        "                                                       'ml_dtypes')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(PKG.parent)})
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_source_scan_finds_no_reference_imports():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 20
    for f in files:
        roots = _imported_roots(f)
        assert not roots & {"jax", "jaxlib", "repro", "ml_dtypes"}, (f, roots)
        text = f.read_text()
        for needle in ("import jax", "from repro.", "import repro.", "from repro import"):
            assert needle not in text, (f, needle)


@pytest.mark.parametrize("helper", ["_torch_sharded_ranks.py",
                                    "_torch_sharded_serving_ranks.py"])
def test_rank_helpers_import_no_reference(helper):
    """The modules the spawned ranks import start without JAX."""
    roots = _imported_roots(pathlib.Path(__file__).resolve().parent / helper)
    assert not roots & {"jax", "jaxlib", "repro", "ml_dtypes"}, roots


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dmf.DMFConfig(n_users=6, n_items=5, dim=4)
    state = dmf.init_state(cfg, device="cpu")
    index = build_candidate_index(np.zeros(5, np.int64), np.zeros(6, np.int64))
    train = np.array([[0, 1], [2, 3]])
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(state, index, train=train)
    with pytest.raises(RuntimeError, match="cuda"):
        dmf.init_state(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        dmf.state_from_numpy(np.zeros((6, 4)), np.zeros((6, 5, 4)), np.zeros((6, 5, 4)))
    with pytest.raises(RuntimeError, match="cuda"):
        graph.neighbor_table_from_dense(np.eye(6, dtype=np.float32))
    with pytest.raises(ValueError):
        device_lib.resolve("mps")
    assert device_lib.resolve("cpu") == torch.device("cpu")
    eng = ServingEngine(state, index, train=train, device="cpu")
    assert eng.state.U.device.type == "cpu" and eng.seen.device.type == "cpu"


def test_training_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dmf.DMFConfig(n_users=6, n_items=5, dim=4, batch_size=2, dp_sigma=1.0, dp_clip=0.5)
    state = dmf.init_state(cfg, device="cpu")
    train = np.array([[0, 1], [2, 3], [4, 0], [5, 2]])
    nbr = graph.neighbor_table_from_dense(np.eye(6, dtype=np.float32), device="cpu")
    rng = np.random.default_rng(0)
    with pytest.raises(RuntimeError, match="cuda"):
        dmf.fit(cfg, train, nbr, epochs=1)
    with pytest.raises(RuntimeError, match="cuda"):
        dmf.train_epoch(state, nbr, train, cfg, rng)
    with pytest.raises(RuntimeError, match="cuda"):
        dmf.train_epoch_dense(state, np.eye(6), train, cfg, rng)
    with pytest.raises(RuntimeError, match="cuda"):
        dmf.evaluate(state, train, train, 6, 5)
    with pytest.raises(RuntimeError, match="cuda"):
        dmf.evaluate_dense(state, train, train, 6, 5)
    with pytest.raises(RuntimeError, match="cuda"):
        dmf_train.main(["--epochs", "1"])
    # asked for the CPU, each runs there and leaves the state where it was
    state, loss = dmf.train_epoch(state, nbr, train, cfg, rng, device="cpu")
    assert np.isfinite(loss) and state.P.device.type == "cpu"
    assert set(dmf.evaluate(state, train, train, 6, 5, device="cpu")) == {
        "P@5", "R@5", "P@10", "R@10"}
    assert dmf.fit(cfg, train, nbr, epochs=1, device="cpu").state.U.device.type == "cpu"


def test_tiled_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sf = SyntheticFactors.create(6, 5, 4, seed=0)
    index = build_candidate_index(np.zeros(5, np.int64), np.zeros(6, np.int64))
    users, items = np.arange(6), np.zeros((6, 3), np.int64)
    with pytest.raises(RuntimeError, match="cuda"):
        sf.item_rows(users, items)
    with pytest.raises(RuntimeError, match="cuda"):
        sf.dense_rows(users)
    with pytest.raises(RuntimeError, match="cuda"):
        TiledFactorStore.synthetic(sf, index, seen_per_user=1)
    host = TiledFactorStore.synthetic(sf, index, seen_per_user=1, device="cpu")
    fields = (host.U.numpy(), host.slab.numpy(), host.seen.numpy(), index, host.cold,
              host.item_counts)
    with pytest.raises(RuntimeError, match="cuda"):
        store_from_numpy(*fields)
    # asked for the CPU, each runs there
    assert sf.item_rows(users, items, device="cpu").device.type == "cpu"
    assert host.slab.device.type == "cpu" and host.device.type == "cpu"
    assert store_from_numpy(*fields, device="cpu").slab.device.type == "cpu"


def test_baseline_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    from repro_torch.core import baselines
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mf = baselines.MFConfig(n_users=6, n_items=12, dim=4, batch_size=2)
    bpr = baselines.BPRConfig(n_users=6, n_items=12, dim=4, batch_size=2)
    train = np.array([[0, 1], [2, 3], [4, 0], [5, 2]])
    with pytest.raises(RuntimeError, match="cuda"):
        baselines.fit_mf(mf, train, epochs=1)
    with pytest.raises(RuntimeError, match="cuda"):
        baselines.fit_bpr(bpr, train, epochs=1)
    with pytest.raises(RuntimeError, match="cuda"):
        baselines.init_mf(mf)
    with pytest.raises(RuntimeError, match="cuda"):
        baselines.mf_state_from_numpy(np.zeros((6, 4)), np.zeros((12, 4)))
    # asked for the CPU, each runs there
    state, losses = baselines.fit_mf(mf, train, epochs=1, device="cpu")
    assert state.U.device.type == "cpu" and np.isfinite(losses).all()
    with pytest.raises(RuntimeError, match="cuda"):
        baselines.evaluate_mf(state, train, train, 6, 12)
    assert set(baselines.evaluate_mf(state, train, train, 6, 12, device="cpu")) == {
        "P@5", "R@5", "P@10", "R@10"}
    assert baselines.fit_bpr(bpr, train, epochs=1, device="cpu")[0].V.device.type == "cpu"


def test_robustness_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch, tmp_path):
    from repro_torch.checkpoint import ckpt
    from repro_torch.privacy import audit
    from repro_torch.robustness import ChurnConfig, DelayRing, DefenseConfig, recovery
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dmf.DMFConfig(n_users=6, n_items=5, dim=4, batch_size=2)
    state = dmf.init_state(cfg, device="cpu")
    train = np.array([[0, 1], [2, 3], [4, 0], [5, 2]])
    nbr = graph.neighbor_table_from_dense(np.eye(6, dtype=np.float32), device="cpu")
    plan = ChurnConfig(dropout=0.3, delay_classes=(0, 1), seed=1).compile(6, 2)
    rng = np.random.default_rng(0)
    with pytest.raises(RuntimeError, match="cuda"):
        dmf.train_epoch_churn(state, nbr, train, cfg, rng, 0, plan, None)
    with pytest.raises(RuntimeError, match="cuda"):
        dmf.fit(cfg, train, nbr, epochs=1, churn=ChurnConfig(), defense=DefenseConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        DelayRing.create(1, 4, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        audit.observe_messages(cfg, train, nbr)
    with pytest.raises(RuntimeError, match="cuda"):
        audit.run_audit(cfg, train, nbr, 6, 5)
    recovery.save_training(tmp_path, 1, state, rng)
    with pytest.raises(RuntimeError, match="cuda"):
        recovery.load_training(tmp_path, state)
    with pytest.raises(RuntimeError, match="cuda"):
        ckpt.restore(tmp_path / "step_1", {"state": {"U": state.U}})
    # asked for the CPU, each runs there; numpy leaves need no device at all
    numpy_like = {"state": {"U": state.U.numpy()}}
    assert ckpt.restore(tmp_path / "step_1", numpy_like)["state"]["U"].shape == (6, 4)
    ring = DelayRing.create(1, 16, 4, device="cpu")      # 4 ratings x (1 + 3 negatives)
    st, loss = dmf.train_epoch_churn(state, nbr, train, cfg, rng, 0, plan, ring, device="cpu")
    assert np.isfinite(loss) and ring.gp.device.type == "cpu"
    back = recovery.load_training(tmp_path, state, device="cpu")[0]
    assert back.P.device.type == "cpu"
    assert audit.observe_messages(cfg, train, nbr, device="cpu").gp.shape == (16, 4)


def test_sharded_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    from repro_torch.launch import mesh
    from repro_torch.sharding import dmf as sharded_dmf
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dmf.DMFConfig(n_users=6, n_items=5, dim=4, batch_size=2, n_shards=2)
    train = np.array([[0, 1], [2, 3], [4, 0], [5, 2]])
    nbr = graph.neighbor_table_from_dense(np.eye(6, dtype=np.float32), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        dmf.fit(cfg, train, nbr, epochs=1)
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.spawn_ranks(print, 2, backend="gloo", device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        dmf_train.main(["--epochs", "1", "--n-shards", "2"])
    # asked for the CPU, they need a process group of n_shards ranks instead
    with pytest.raises(RuntimeError, match="process group"):
        dmf.fit(cfg, train, nbr, epochs=1, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        sharded_dmf.learner_group(2, device="cpu")


def test_lm_serving_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import config as mc
    from repro_torch.models import transformer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = mc.reduced(registry.get_config("qwen1.5-4b"))
    with pytest.raises(RuntimeError, match="cuda"):
        serve.make_prefill_step(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.make_decode_step(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        transformer.Transformer(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        transformer.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        transformer.init_cache(cfg, 1, 8)
    with pytest.raises(ValueError):
        transformer.Transformer(cfg, device="mps")
    # the meta device needs no card; asked for the CPU, each runs there
    assert transformer.abstract_params(cfg).final_norm.device.type == "meta"
    model = transformer.init_params(cfg, seed=0, device="cpu")
    tree = transformer.params_to_numpy(model)
    with pytest.raises(RuntimeError, match="cuda"):
        transformer.params_from_numpy(tree, cfg)
    assert transformer.params_from_numpy(tree, cfg, device="cpu").embed.device.type == "cpu"
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    logits, pcache = serve.make_prefill_step(cfg, device="cpu")(model, {"tokens": tokens})
    with pytest.raises(RuntimeError, match="cuda"):
        serve.cache_from_prefill(cfg, pcache, 8)
    cache = serve.cache_from_prefill(cfg, pcache, 8, device="cpu")
    logits, cache = serve.make_decode_step(cfg, device="cpu")(model, cache, tokens[:, :1], 4)
    assert logits.device.type == "cpu" and cache["0"]["k"].device.type == "cpu"


def test_lm_training_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.models import config as mc
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = mc.reduced(registry.get_config("qwen1.5-4b"), n_layers=1, d_model=32, n_heads=2,
                     head_dim=16, v_head_dim=16, d_ff=32, vocab_size=16)
    opt = adamw(1e-3)
    for sync in ("allreduce", "gossip"):
        with pytest.raises(RuntimeError, match="cuda"):
            train.make_train_step(cfg, opt, sync=sync)
    tree = transformer.params_to_numpy(transformer.init_params(cfg, seed=0, device="cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        train.train_state_from_numpy(cfg, opt, tree)
    with pytest.raises(ValueError, match="sync"):
        train.make_train_step(cfg, opt, sync="ring", device="cpu")
    # asked for the CPU, each runs there
    batch = {"tokens": np.zeros((4, 8), np.int32), "labels": np.ones((4, 8), np.int32)}
    for sync in ("allreduce", "gossip"):
        step, init_fn = train.make_train_step(cfg, opt, sync=sync, n_learners=2, device="cpu")
        state, metrics = step(init_fn(0), batch)
        assert metrics["loss"].device.type == "cpu" and np.isfinite(float(metrics["loss"]))
        assert int(state.opt_state.step.reshape(-1)[0]) == 1
    state = train.train_state_from_numpy(cfg, opt, tree, device="cpu")
    with pytest.raises(ValueError, match="the step"):    # a model of another config
        train.make_train_step(dataclasses.replace(cfg, name="other"), opt, device="cpu")[0](
            state, batch)
