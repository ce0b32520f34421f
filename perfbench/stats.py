"""The window's arithmetic: rates over the whole window, percentiles over
every call, and the spread that sets a bound."""

from __future__ import annotations

import statistics

import numpy as np


def rate(count: float, window_s: float) -> float:
    """Work per second over the whole window (no median of chunks: a stall
    anywhere in the window lowers it)."""
    return count / window_s


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, linear between
    order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def spread(values) -> float:
    """Distance between the first and third quartiles over the median, as
    ``statistics.quantiles(values, n=4)`` gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(q2)
