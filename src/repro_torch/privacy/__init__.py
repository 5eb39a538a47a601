"""Differentially-private gradient exchange — port of `src/repro/privacy/`
(`mechanism`, `accountant`; the leakage audit comes with a later slice).

`DMFConfig(dp_clip=…, dp_sigma=…, dp_seed=…)` turns the mechanism on for the
training epoch and the online refresh. With ``dp_sigma=0`` and
``dp_clip=inf`` every path runs the un-noised step.
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
