"""Cubic-spline chain resampling (host-side, scipy).

Replaces the reference's cxx-spline usage in ``transition_interphase.cpp``:
fit a not-a-knot cubic spline per coordinate through the coarse beads at
parameters t = (i + 0.5)/n and resample at the fine resolution
(transition_interphase.cpp:15-40).
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import CubicSpline


def resample_chain(coarse: np.ndarray, new_length: int) -> np.ndarray:
    """Resample an (M, 3) polyline to (new_length, 3) via not-a-knot splines."""
    m = len(coarse)
    ts = (0.5 + np.arange(m)) / m
    t_new = (0.5 + np.arange(new_length)) / new_length
    if m >= 4:
        out = np.stack(
            [CubicSpline(ts, coarse[:, k], bc_type="not-a-knot")(t_new) for k in range(3)],
            axis=1,
        )
    elif m >= 2:
        # Too few points for a not-a-knot cubic; degrade to linear.
        out = np.stack(
            [np.interp(t_new, ts, coarse[:, k]) for k in range(3)], axis=1
        )
    elif m == 1:
        out = np.repeat(coarse, new_length, axis=0)
    else:
        raise ValueError("cannot resample an empty chain")
    return out
