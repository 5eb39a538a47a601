"""`models/transformer.py::loss_fn` against the reference for the MoE
configs (DeepSeek-V2 Lite and 236B, Jamba: routed top-k with capacity
drops, shared experts, the router's aux loss), on the CPU, as
`tests/test_torch_lm_loss.py` holds the others: the same weights, batch
and tolerances (the loss within 1e-5 relative, each gradient leaf within
1e-4 × the reference leaf's largest magnitude). A file of its own because
the reference's MoE scan takes ~15 s a config to trace here.
"""
import pytest

pytest.importorskip("jax")
from tests.test_torch_lm_loss import MOE, hold_loss_and_grads, one_thread  # noqa: E402, F401


@pytest.mark.parametrize("arch", MOE)
def test_moe_loss_fn_value_and_grads_match_the_reference(arch):
    hold_loss_and_grads(arch)
