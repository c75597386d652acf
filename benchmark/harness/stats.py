"""Order statistics of a window's samples."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile by the nearest rank: the smallest sample with at
    least q% of the samples at or below it."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]
