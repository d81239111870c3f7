"""IMU-rate ring buffer ops (behavioral spec: reference
``ekf/state_buffer.h``, ``src/x/ekf/state_buffer.cpp``).

Layout: the buffer is a single PACKED (B, 24) array rather than a stacked
CoreState pytree — slot reads/writes become ONE gather/update instead of
nine per-leaf dynamic-update-slices, each of which costs a launch
regardless of its size.

Row layout: [time, seq, p(3), v(3), q(4), b_w(3), b_a(3), w_m(3), a_m(3)].
Invalid slots carry time < 0 (reference kInvalid). ``seq`` is stored in
the float row (exact up to 2^24 samples).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .state import CoreState

# numpy scalar, NOT a jax array: a module-level device array would be
# fetched device->host at every trace lowering (ir_constant)
INVALID_IDX = np.int32(-1)

ROW_WIDTH = 24
_TIME, _SEQ = 0, 1
_P, _V, _Q, _BW, _BA, _WM, _AM = 2, 5, 8, 12, 15, 18, 21


def pack_core(core: CoreState) -> jnp.ndarray:
    """CoreState -> (24,) row (dtype follows core.p)."""
    dtype = core.p.dtype
    return jnp.concatenate(
        [
            jnp.asarray(core.time, dtype)[None],
            jnp.asarray(core.seq, dtype)[None],
            core.p, core.v, core.q, core.b_w, core.b_a, core.w_m, core.a_m,
        ]
    )


def unpack_core(row: jnp.ndarray) -> CoreState:
    """(..., 24) row(s) -> CoreState (leaves keep leading batch dims)."""
    return CoreState(
        time=row[..., _TIME],
        seq=row[..., _SEQ].astype(jnp.int32),
        p=row[..., _P:_V],
        v=row[..., _V:_Q],
        q=row[..., _Q:_BW],
        b_w=row[..., _BW:_BA],
        b_a=row[..., _BA:_WM],
        w_m=row[..., _WM:_AM],
        a_m=row[..., _AM:ROW_WIDTH],
    )


def empty_buffer(buffer_size: int, dtype=jnp.float32) -> jnp.ndarray:
    buf = jnp.zeros((buffer_size, ROW_WIDTH), dtype)
    buf = buf.at[:, _TIME].set(-1.0)  # kInvalid
    buf = buf.at[:, _Q + 3].set(1.0)  # identity quaternion (w)
    return buf


def times(buffer: jnp.ndarray) -> jnp.ndarray:
    return buffer[..., _TIME]


def get_slot(buffer: jnp.ndarray, idx) -> CoreState:
    """Read ring slot(s) as an (un)stacked CoreState."""
    return unpack_core(buffer[idx])


def set_slot(buffer: jnp.ndarray, idx, core: CoreState) -> jnp.ndarray:
    """Write one ring slot (single packed row update)."""
    return buffer.at[idx].set(pack_core(core))


def set_rows(buffer: jnp.ndarray, idxs: jnp.ndarray, rows: jnp.ndarray, mask):
    """Masked multi-row write (used by tail repropagation)."""
    cur = buffer[idxs]
    return buffer.at[idxs].set(jnp.where(mask[:, None], rows, cur))


def pack_cores(cores: CoreState) -> jnp.ndarray:
    """Stacked CoreState (leading dim K) -> (K, 24)."""
    dtype = cores.p.dtype
    return jnp.concatenate(
        [
            jnp.asarray(cores.time, dtype)[:, None],
            jnp.asarray(cores.seq, dtype)[:, None],
            cores.p, cores.v, cores.q, cores.b_w, cores.b_a, cores.w_m, cores.a_m,
        ],
        axis=-1,
    )


def closest_idx(times_arr: jnp.ndarray, t, time_margin) -> jnp.ndarray:
    """Ring index of the valid state closest in time to ``t``.

    Mirrors ``StateBuffer::closestIdx`` (``state_buffer.cpp:26-63``):
    measurements more than ``time_margin`` outside the covered range return
    INVALID_IDX and the update is dropped.
    """
    valid = times_arr >= 0
    dt = jnp.where(valid, jnp.abs(times_arr - t), jnp.inf)
    idx = jnp.argmin(dt)
    ok = dt[idx] <= time_margin
    return jnp.where(ok, idx.astype(jnp.int32), INVALID_IDX)


def ring_range(start, length: int, buffer_size: int) -> jnp.ndarray:
    """Indices of the ``length`` ring slots after ``start`` (static length)."""
    return (start + 1 + jnp.arange(length, dtype=jnp.int32)) % buffer_size


def steps_between(from_idx, to_idx, buffer_size: int) -> jnp.ndarray:
    """Number of ring steps from ``from_idx`` forward to ``to_idx``."""
    return (to_idx - from_idx) % buffer_size
