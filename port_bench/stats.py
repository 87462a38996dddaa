"""Small statistics of the benchmark: the percentile of the port's load
runner (lws_tpu_torch/loadgen/runner.py `_percentile`, linear between
ranks, copied) and the spread the benchmark's bounds are set from."""

from __future__ import annotations

import statistics
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-quantile (0..1) of `values`, linear between sorted ranks."""
    vals = sorted(values)
    if not vals:
        return None
    if len(vals) == 1:
        return vals[0]
    rank = q * (len(vals) - 1)
    lo = int(rank)
    frac = rank - lo
    if lo + 1 >= len(vals):
        return vals[-1]
    return vals[lo] * (1 - frac) + vals[lo + 1] * frac


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles, as Python's
    statistics.quantiles(values, n=4) gives them, over the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
