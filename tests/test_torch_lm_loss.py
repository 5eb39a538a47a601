"""The LM training loss in the port against the reference, on the CPU:
`models/transformer.py::loss_fn` in `repro_torch` against `repro`.

* `loss_fn`'s value and its gradient for every parameter against
  `jax.value_and_grad(ref_tf.loss_fn)` at `reduced()` width (fp32), with
  the randomised numpy weights of `tests/test_torch_lm_serving.py` (every
  all-zero or all-one leaf moved off its constant), a remainder CE chunk
  (S=24, ``loss_chunk=16``) and -1 labels: the loss within 1e-5 relative,
  each gradient leaf within 1e-4 × the reference leaf's largest
  magnitude. yi-34b-swa runs with a window of 8 (below S) in both. The
  MoE configs are in `tests/test_torch_lm_loss_moe.py`;
  `chunked_cross_entropy`, the chunked attention and SSD paths and remat
  in `tests/test_torch_lm_loss_paths.py`.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.models import config as ref_mc  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.models.config import LayerSpec as RefLayerSpec  # noqa: E402
from repro_torch import device as device_lib  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import config as mc  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.config import LayerSpec  # noqa: E402
from repro_torch.utils import tree as tree_lib  # noqa: E402

device_lib.settle_cpu()
LOSS_RTOL, GRAD_REL = 1e-5, 1e-4
B, S, LOSS_CHUNK = 2, 24, 16
DENSE = ["minicpm3-4b", "llama-3.2-vision-90b", "qwen1.5-4b", "musicgen-medium",
         "minitron-4b", "mamba2-2.7b", "yi-34b", "yi-34b-swa"]
MOE = ["deepseek-v2-lite-16b", "deepseek-v2-236b", "jamba-1.5-large-398b"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these small tensors: the suite runs its files
    in parallel, and with every core busy each parallel region waits for its
    threads (a gossip loop of 2 s took 136 s at 8 threads on 8 busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomized(params, seed):
    """The reference's parameter tree as numpy float32, every all-zero or
    all-one leaf replaced by random values around it."""
    rng = np.random.default_rng(seed)

    def one(a):
        a = np.asarray(a, np.float32)
        if np.all(a == 0) or np.all(a == 1):
            a = (a + rng.normal(0, 0.3, a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map(one, jax.device_get(params))


def configs(arch, **kw):
    kw = {"loss_chunk": LOSS_CHUNK, **kw}
    ref = ref_mc.reduced(ref_registry.get_config(arch), **kw)
    port = mc.reduced(registry.get_config(arch), **kw)
    if arch == "yi-34b-swa":   # a window below S, so that the band masks
        ref = dataclasses.replace(ref, period=(RefLayerSpec(kind="attn", sliding_window=8),))
        port = dataclasses.replace(port, period=(LayerSpec(kind="attn", sliding_window=8),))
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


def lm_batch(cfg, seed):
    """Token ids and labels (a few -1) as numpy int32; media for vision."""
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    batch["labels"][0, :3] = -1
    batch["labels"][1, -2:] = -1
    if cfg.n_image_tokens:
        batch["media"] = rng.normal(0, 0.5, (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def port_grads(model) -> dict:
    """The model's gradients as the reference's tree paths, stacked over periods."""
    out = {}
    for path, (_, params) in transformer._reference_paths(model).items():
        grads = [p.grad.numpy() for p in params]
        out[path] = np.stack(grads) if path.startswith("blocks/") else grads[0]
    return out


def hold_loss_and_grads(arch, **overrides):
    ref_cfg, cfg = configs(arch, **overrides)
    tree = randomized(ref_tf.init_params(ref_cfg, jax.random.PRNGKey(1))[0], 1)
    batch = lm_batch(cfg, 2)
    want_loss, want_grads = jax.jit(jax.value_and_grad(lambda p, b: ref_tf.loss_fn(p, b, ref_cfg)))(
        jax.tree_util.tree_map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    model = transformer.params_from_numpy(tree, cfg, device="cpu")
    loss = transformer.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL, atol=0)
    want = dict(tree_lib.tree_paths(jax.device_get(want_grads)))
    got = port_grads(model)
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=GRAD_REL * float(np.abs(w).max()), err_msg=path)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_fn_value_and_grads_match_the_reference(arch):
    hold_loss_and_grads(arch)
