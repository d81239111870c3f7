"""Chi-square quantile lookup tables.

The reference evaluates ``boost::math::chi_squared`` quantiles per track at
runtime (e.g. ``msckf_update.cpp:459-461``). On device the dof is a traced
integer bounded by 2*max_track_length, so we bake a dense quantile table at
trace time (computed host-side with scipy) and gather from it on device.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
from scipy.stats import chi2 as _chi2


@functools.lru_cache(maxsize=None)
def _table_np(confidence: float, max_dof: int) -> np.ndarray:
    dof = np.arange(max_dof + 1)
    t = _chi2.ppf(confidence, np.maximum(dof, 1))
    t[0] = 0.0  # dof 0: gate everything out
    return t


def chi2_quantile_table(confidence: float, max_dof: int, dtype=jnp.float32):
    """(max_dof+1,) table; index with a traced dof."""
    return jnp.asarray(_table_np(confidence, max_dof), dtype)


def chi2_gate(gamma, dof, confidence: float, max_dof: int):
    """True if gamma passes (is below) the chi2 quantile at ``dof``.

    dof is clipped into [0, max_dof]; dof<=0 always fails the gate.
    """
    table = chi2_quantile_table(confidence, max_dof, jnp.asarray(gamma).dtype)
    d = jnp.clip(dof, 0, max_dof)
    return (gamma < table[d]) & (dof > 0)
