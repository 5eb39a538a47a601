"""Kernel 2 (`topk_rows_kernel`) serving n users' full rows through P and
Q: each user's U row, seen row (one byte a POI), row id and slate (k ids
and k scores), and the P and Q factors of every unseen POI (a seen POI's
factors are not needed). Operations: an add and a multiply-add a factor of
each unseen POI. As `chip_smoke.py`'s phase 4 counts the same kernel."""


def count(n_users: int, n_items: int, dim: int, k: int, seen: int) -> tuple[float, float]:
    """(bytes, operations) for ``n_users`` real users holding ``seen``
    seen entries in all."""
    live = n_users * n_items - seen
    nbytes = n_users * (dim * 4 + n_items + 8 + k * 8) + live * dim * 4 * 2
    return float(nbytes), float(live * dim * 3)
