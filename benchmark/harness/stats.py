"""Rates and percentiles from raw samples, never from histograms."""
from __future__ import annotations

import math
import statistics

import numpy as np


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of the raw values by the nearest-rank
    rule: the smallest value with at least q% of the values at or below
    it.  A missing (failed or lost) sample is +inf, so it can only push
    the percentile up."""
    v = np.sort(np.asarray(values, np.float64))
    if v.size == 0:
        return math.inf
    rank = max(int(math.ceil(q / 100.0 * v.size)), 1)
    return float(v[rank - 1])


def spread(values) -> float:
    """Distance between the first and third quartiles as a share of the
    median (statistics.quantiles' default method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
