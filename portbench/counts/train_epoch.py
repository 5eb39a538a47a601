"""One DMF epoch of Alg. 1 in whole rounds, the least the chip must move:
per event its ids, rating and confidence as given (two int64, two
float32), the sender's u row and its p and q entries read, the u row and
the q entry written back; per receiver of the sender's walk table (its
nonzero slots, the sender's own included) the slot's id and weight read
and its p entry read and written. Operations: kernel 3's per event, plus a
multiply-add a factor a receiver."""
import numpy as np


def count(senders: np.ndarray, fanout: np.ndarray, dim: int) -> tuple[float, float]:
    """(bytes, operations) for the epoch's events in whole rounds, given
    their senders (n,) and each user's receiver count ``fanout`` (I,)."""
    n = len(senders)
    slots = float(np.asarray(fanout, np.int64)[senders].sum())
    nbytes = n * 24 + n * 3 * dim * 4 + n * 2 * dim * 4 + slots * (12 + 2 * dim * 4)
    return float(nbytes), float(n * (12 * dim + 5) + slots * 2 * dim)
