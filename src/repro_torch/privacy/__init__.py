"""Differentially-private gradient exchange — port of `src/repro/privacy/`
(`mechanism`, `accountant`, `audit`).

`DMFConfig(dp_clip=…, dp_sigma=…, dp_seed=…)` turns the mechanism on for the
training epoch, the churn epoch and the online refresh. With
``dp_sigma=0`` and ``dp_clip=inf`` every path runs the un-noised step. The
leakage audit (`audit`) replays the training path, captures the outbox
stream and runs the rating-reconstruction and membership attacks on it.
"""
from repro_torch.privacy.accountant import (  # noqa: F401
    GaussianAccountant,
    rdp_subsampled_gaussian,
    rdp_to_epsilon,
    sigma_for_epsilon,
)
from repro_torch.privacy.mechanism import (  # noqa: F401
    dp_enabled,
    epoch_noise_seed,
    noise_std,
    screening_threshold,
)
from repro_torch.privacy.audit import (  # noqa: F401
    MessageLog,
    membership_inference_attack,
    observe_messages,
    rating_reconstruction_attack,
    run_audit,
    screening_report,
)
from repro_torch.privacy import audit  # noqa: F401
