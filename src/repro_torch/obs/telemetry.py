"""Per-epoch training telemetry — port of `src/repro/obs/telemetry.py`
(`TELE_KEYS`, `TELE_W`, `device_stats_to_dict`, `EpochCollector`).

The device half lives in `core/dmf.py`: with ``tele`` on, every minibatch
step returns one ``TELE_W``-wide float32 vector of read-only reductions
over what the step computes anyway (squared U/Q update norms, released
message mass, scattered propagation mass, delivered-message counts,
Byzantine screening counts). The epoch sums them on the device and reads
the sum once, beside its losses. No rng draw, no factor write: factor
trajectories are bit for bit those of a run without telemetry.

The host half (`EpochCollector`) merges them with what only the host
knows (the accountant's ε, the churn plan's online count, the delay
ring's occupancy, wall seconds) into one event dict per epoch, streamed
as JSONL on request and mirrored into the global metrics registry.
"""
from __future__ import annotations

import json

import numpy as np

# Slot layout of the per-step reduction vector; the order is part of the
# device-host contract: append, never reorder.
TELE_KEYS = (
    "u_update_sq",     # Σ du² over the batch (lr-scaled U delta)
    "q_update_sq",     # Σ dq² over the batch (lr-scaled Q delta)
    "msg_sq",          # Σ gp² over released (post-DP, post-attack) messages
    "scatter_sq",      # Σ (θ·w·gp)² over every applied propagation slot
    "n_messages",      # delivered neighbour-slot count (after the fault gates)
    "screen_accept",   # deliveries surviving the screen (Byzantine path only)
    "screen_reject",   # deliveries zeroed by the screen (Byzantine path only)
)
TELE_W = len(TELE_KEYS)


def device_stats_to_dict(tele) -> dict:
    """A (TELE_W,) — or (n_shards, TELE_W) — reduction block to named
    host numbers. Norms are the square roots of the summed squares; counts
    sum across shards and are also kept per shard."""
    a = np.asarray(tele, np.float64)
    if a.ndim == 1:
        a = a[None, :]
    if a.shape[-1] != TELE_W:
        raise ValueError(f"telemetry block of shape {a.shape}, expected (..., {TELE_W})")
    tot = a.sum(axis=0)
    return {
        "u_update_norm": float(np.sqrt(tot[0])),
        "q_update_norm": float(np.sqrt(tot[1])),
        "p_msg_norm": float(np.sqrt(tot[2])),
        "p_scatter_norm": float(np.sqrt(tot[3])),
        "n_messages": int(tot[4]),
        "messages_per_shard": [int(x) for x in a[:, 4]],
        "screen_accept": int(tot[5]),
        "screen_reject": int(tot[6]),
    }


class EpochCollector:
    """Accumulates one event dict per training epoch.

    ``jsonl_path`` streams each event as one JSON line as it lands (line
    buffered, so a crashed run keeps its prefix). Events are also mirrored
    into the global `obs.metrics` registry."""

    def __init__(self, jsonl_path=None):
        self.events: list[dict] = []
        self._file = open(jsonl_path, "a", buffering=1) if jsonl_path else None

    def record(self, epoch: int, *, train_loss: float, device_stats=None, test_loss=None,
               accountant=None, plan=None, ring=None, byz=None,
               wall_s: float | None = None) -> dict:
        ev: dict = {"epoch": int(epoch), "train_loss": float(train_loss)}
        if test_loss is not None:
            ev["test_loss"] = float(test_loss)
        if wall_s is not None:
            ev["wall_s"] = float(wall_s)
        if device_stats is not None:
            d = (device_stats if isinstance(device_stats, dict)
                 else device_stats_to_dict(device_stats))
            if not (byz is not None and getattr(byz, "screen", False)):
                # the zeros of an unscreened step mean "not measured", not
                # "nothing rejected": they are not reported as counts
                d = {k: v for k, v in d.items() if k not in ("screen_accept", "screen_reject")}
            ev.update(d)
        if accountant is not None and accountant.eps_trajectory:
            ev["dp_eps"] = float(accountant.eps_trajectory[-1])
        if plan is not None:
            ev["n_online"] = int(np.asarray(plan.online[epoch]).sum())
        if ring is not None:
            # messages still buffered for a later epoch after this one's
            # deliveries and writes
            ev["ring_occupancy"] = int((np.asarray(ring.due) > epoch).sum())
        self.events.append(ev)
        if self._file is not None:
            self._file.write(json.dumps(ev) + "\n")
        self._publish_event(ev)
        return ev

    def _publish_event(self, ev: dict) -> None:
        from repro_torch.obs import metrics as obs_metrics
        reg = obs_metrics.get_registry()
        reg.counter("train_epochs_total").inc()
        reg.gauge("train_loss").set(ev["train_loss"])
        if "dp_eps" in ev:
            reg.gauge("train_dp_eps").set(ev["dp_eps"])
        if "n_online" in ev:
            reg.gauge("train_online_learners").set(ev["n_online"])
        if "ring_occupancy" in ev:
            reg.gauge("train_ring_occupancy").set(ev["ring_occupancy"])
        if "n_messages" in ev:
            reg.counter("train_messages_total").inc(ev["n_messages"])
            for s, c in enumerate(ev.get("messages_per_shard", ())):
                reg.counter("train_messages_per_shard_total").inc(c, shard=s)
        if "screen_accept" in ev:
            reg.counter("train_screen_accept_total").inc(ev["screen_accept"])
            reg.counter("train_screen_reject_total").inc(ev["screen_reject"])
        if "wall_s" in ev:
            reg.histogram("train_epoch_seconds").observe(ev["wall_s"])

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
