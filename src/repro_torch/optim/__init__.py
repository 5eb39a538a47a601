"""Optimizers and schedules — port of `src/repro/optim/__init__.py:1-13`,
which exports the same names; the port adds the optimiser state's
carry-over (`state_to_numpy`, `state_from_numpy`)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    AdamState,
    OptState,
    Optimizer,
    adamw,
    sgd,
    momentum,
    apply_updates,
    state_from_numpy,
    state_to_numpy,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant,
    cosine_decay,
    linear_warmup_cosine,
)
