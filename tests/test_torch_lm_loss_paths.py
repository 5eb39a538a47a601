"""The LM training loss's paths in the port against the reference, on the
CPU: `models/layers.py::chunked_cross_entropy`, `loss_fn` through the
chunked forms of attention and SSD, and the remat of `forward`, in
`repro_torch` against `repro` (`tests/test_torch_lm_loss.py` holds every
config at `reduced()`, where attention takes its dense shortcut and SSD
one chunk).

* `chunked_cross_entropy`'s value and its gradients (hidden states and
  head) against `jax.value_and_grad` of the reference's, with a remainder
  chunk, -1 labels and all labels -1: the value within 1e-6 relative,
  each gradient within 1e-5 × its largest magnitude.
* `loss_fn`'s value and gradients as in `tests/test_torch_lm_loss.py`
  (1e-5 relative, 1e-4 × the leaf's largest magnitude) with attention in
  8-token chunks (the blockwise online softmax and its in-place tile
  writes, GQA and MLA, with a window of 8; the triangular schedule) and
  SSD in 8-token chunks (the cross-chunk loop).
* Remat on equals remat off bit for bit, on those paths and on every
  config: the loss, every gradient, and the forward under
  `inference_mode`.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import layers as ref_layers  # noqa: E402
from repro_torch import device as device_lib  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from tests.test_torch_lm_loss import (DENSE, MOE, configs, hold_loss_and_grads,  # noqa: E402
                                      lm_batch, one_thread, port_grads)  # noqa: F401

device_lib.settle_cpu()
PATHS = [("qwen1.5-4b", {"attn_chunk": 8}),
         ("qwen1.5-4b", {"attn_chunk": 8, "triangular_attention": True}),
         ("minicpm3-4b", {"attn_chunk": 8}),
         ("yi-34b-swa", {"attn_chunk": 8}),
         ("mamba2-2.7b", {"ssm_chunk": 8})]


@pytest.mark.parametrize("arch,overrides", PATHS)
def test_loss_fn_through_chunked_attention_and_ssd_matches_the_reference(arch, overrides):
    hold_loss_and_grads(arch, **overrides)


# --------------------------------------------------------- chunked CE
@pytest.mark.parametrize("S_,chunk,ignore", [(40, 16, "some"), (40, 64, "some"), (32, 8, "none"),
                                              (24, 16, "all")])
def test_chunked_cross_entropy_matches_the_reference(S_, chunk, ignore):
    """(40, 16): two chunks and a remainder of 8; (40, 64): one chunk of
    S; all labels -1: the loss is 0 (the count clamped to 1)."""
    rng = np.random.default_rng(S_ + chunk)
    D, V = 12, 50
    h = rng.normal(0, 1.0, (2, S_, D)).astype(np.float32)
    head = rng.normal(0, 0.3, (D, V)).astype(np.float32)
    labels = rng.integers(0, V, (2, S_)).astype(np.int32)
    if ignore == "some":
        labels[0, 5:9] = -1
        labels[1, -3:] = -1
    elif ignore == "all":
        labels[:] = -1
    want, (wh, wl) = jax.value_and_grad(
        lambda a, b: ref_layers.chunked_cross_entropy(a, b, jnp.asarray(labels), chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(head))
    for remat in (False, True):
        th = torch.from_numpy(h).requires_grad_()
        thead = torch.from_numpy(head).requires_grad_()
        got = layers.chunked_cross_entropy(th, thead, torch.from_numpy(labels), chunk, remat=remat)
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6, atol=0)
        for g, w in ((th.grad, wh), (thead.grad, wl)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-5 * max(float(np.abs(w).max()), 1e-30))


# --------------------------------------------------------------- remat
@pytest.mark.parametrize("arch,overrides", [(a, {}) for a in DENSE + MOE] + PATHS)
def test_remat_on_equals_remat_off_bit_for_bit(arch, overrides):
    """`cfg.remat` recomputes each period and each CE chunk in the backward;
    the loss and every gradient are the same bits. Under inference_mode
    nothing is checkpointed: the forward equals remat off."""
    _, cfg = configs(arch, **overrides)
    tree = transformer.params_to_numpy(transformer.init_params(cfg, seed=3, device="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in lm_batch(cfg, 4).items()}
    runs = []
    for remat in (False, True):
        model = transformer.params_from_numpy(tree, dataclasses.replace(cfg, remat=remat),
                                              device="cpu")
        loss = transformer.loss_fn(model, batch)
        loss.backward()
        with torch.inference_mode():
            h = transformer.forward(model, batch["tokens"], media=batch.get("media"))[0]
        runs.append((loss.detach(), port_grads(model), h))
    (l0, g0, h0), (l1, g1, h1) = runs
    assert torch.equal(l0, l1)
    assert torch.equal(h0, h1)
    for path in g0:
        np.testing.assert_array_equal(g1[path], g0[path], err_msg=path)
