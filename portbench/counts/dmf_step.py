"""Kernel 3 (`dmf_fused_step_kernel`) over a round of B events: reads the
gathered u, p, q rows (K floats each) and r, conf; writes the u and q
deltas and the p message (K floats each) and the round's loss. About 12K +
5 operations an event (the residual's dot product, three gradients, the
scaling, the loss). As `chip_smoke.py`'s phase 4 counts the same kernel."""


def count(rows: int, dim: int) -> tuple[float, float]:
    """(bytes, operations) of one launch over ``rows`` events."""
    return float(rows * (3 * dim + 2) * 4 + 3 * rows * dim * 4 + 4), float(rows * (12 * dim + 5))
