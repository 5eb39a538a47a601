"""Kernel 6 (`TiledQuant<int8_t>`) serving n real users of the tiled
int8 store in place, counted over what the inputs need: each user's id
and bucket number (8 B each), U row (4 B a factor), scale (4 B), the
codes of the real columns of the user's cell (1 B a factor a column) and
their seen flags (1 B a column), and slate (k ids and k scores, 8 B a
slot); and each distinct cell's real POI ids (4 B a column) once a
dispatch. The padding columns of a window, which the kernel reads and
drops, are not counted. Operations: a multiply and an add a factor, and
the scale's multiply, for each unseen POI of a user's cell."""


def count(n_users: int, user_cols: int, cell_cols: int, n_candidates: int, dim: int,
          k: int) -> tuple[float, float]:
    """(bytes, operations) for ``n_users`` real users whose cells hold
    ``user_cols`` POIs summed over the users, over distinct cells holding
    ``cell_cols`` POIs in all, with ``n_candidates`` unseen POIs in the
    users' cells in all."""
    per_user = 8 + 8 + dim * 4 + 4 + k * 8
    nbytes = n_users * per_user + user_cols * (dim + 1) + cell_cols * 4
    return float(nbytes), float(n_candidates * (2 * dim + 1))
