"""Fault injection and fault tolerance for decentralized training — port of
`src/repro/robustness/`.

* `faults`   — seeded `ChurnConfig`/`ChurnPlan` (dropout, power-law
  sessions, stragglers, late joiners) and the `DelayRing` that applies a
  straggler's messages k epochs late.
* `recovery` — crash-consistent training checkpoints (factors, rng stream,
  delay ring, DP accountant), so `dmf.fit(resume_from=...)` is
  bit-identical to the uninterrupted run.
* `byzantine` — seeded `AttackConfig`/`AttackPlan` message corruption and
  the receiver-side `DefenseConfig` (screening, trimmed-mean / median
  aggregation) applied at every delivery site.
"""
from repro_torch.robustness.faults import (  # noqa: F401
    ChurnConfig,
    ChurnPlan,
    DelayRing,
    no_churn,
)
from repro_torch.robustness.byzantine import (  # noqa: F401
    AGGREGATIONS,
    FAMILIES,
    AttackConfig,
    AttackPlan,
    DefenseConfig,
    no_attack,
)
from repro_torch.robustness import recovery  # noqa: F401
