"""One canonical warning for every uncalibrated-weights surface (a copy of
the JAX package's `utils/calibration.py`, which the port cannot import).

The reference runs calibrated LPIPS. Where no exported weights are given,
every entry point that falls back to random init (the LPIPS loss, the LPIPS
eval metric) warns through this helper, so that the message is loud,
consistent and greppable: a silent random-LPIPS eval prints numbers that
look calibrated.
"""

from __future__ import annotations

import warnings


def warn_uncalibrated(component: str, detail: str) -> None:
    """Emit the canonical uncalibrated-weights warning.

    component: short name ("LPIPS"); detail: what the fallback means and
    how to fix it.
    """
    msg = f"{component} running with RANDOM-INIT (uncalibrated) weights: {detail}"
    warnings.warn(msg, stacklevel=3)
    print(f"[signerf-tpu] WARNING: {msg}")
