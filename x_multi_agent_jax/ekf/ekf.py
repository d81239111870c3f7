"""EKF orchestrator (behavioral spec: reference ``src/x/ekf/ekf.cpp``).

Redesign notes (fixed-shape, accelerator-first):
  * ``processImu`` integrates only the 16-dim core state into the ring
    buffer (reference enqueues a full State incl. a (D,D) covariance and
    propagates it per sample, ``ekf.cpp:130-137``). Covariance propagation
    is deferred: per-step transitions are computed *batched* (vmap over
    buffer slots — the 30x30 Van Loan expms become batched matmuls) and
    compounded in a scan at update time. When no update arrives for
    ``max_update_lag`` samples, the anchor is advanced one step per IMU
    sample, which degenerates to exactly the reference's per-sample
    covariance propagation.
  * The reference's IMU-thread vs update-thread mutex and the optimistic
    buffer-overwrite check (``ekf.cpp:215-239``) vanish by construction:
    everything is one sequenced device program.
  * ``processUpdateMeasurement``'s repropagate-the-tail
    (``ekf.cpp:227-255``) is a masked lax.scan over the ``max_update_lag``
    slots after the update index.

Init state machine (``ekf.h:32-46``): 0 = kNotInitialized, 1 = kStandBy
(init state placed, waiting for first IMU), 2 = kInitialized.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from . import buffer as rb
from ..ops.linalg import highprec
from .propagator import (
    ImuNoise,
    compound_transitions,
    propagate_covariance,
    propagate_mean,
    propagate_mean_batch,
    step_transition,
)
from .state import CoreState, FilterState, StateDims, VisionState


class EkfParams(NamedTuple):
    """Static EKF configuration (hashable -> usable as a jit static arg)."""

    dims: StateDims = StateDims()
    g: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    imu_noise: ImuNoise = ImuNoise()
    a_m_max: float = 50.0  # accel spike threshold [m/s^2] (ekf.cpp:119-128)
    time_margin: float = 0.02  # closestIdx tolerance [s] (vio.cpp:212)
    max_update_lag: int = 64  # static bound on IMU steps between updates

    @property
    def g_vec(self):
        return jnp.asarray(self.g)


# ---------------------------------------------------------------------------
# initialization (reference Ekf::initializeFromState, ekf.cpp:43-64)
# ---------------------------------------------------------------------------


def init_from_state(
    params: EkfParams,
    core: CoreState,
    vision: VisionState,
    cov: jnp.ndarray,
) -> FilterState:
    """Reset the buffer around an initial state; status -> kStandBy."""
    dims = params.dims
    fs = FilterState.zero(dims, dtype=core.p.dtype)
    buf = rb.set_slot(fs.buffer, jnp.asarray(0, jnp.int32), core)
    return dataclasses.replace(
        fs,
        buffer=buf,
        head=jnp.asarray(0, jnp.int32),
        size=jnp.asarray(1, jnp.int32),
        anchor_buf_idx=jnp.asarray(0, jnp.int32),
        cov=cov,
        vision=vision,
        status=jnp.asarray(1, jnp.int32),
    )


# ---------------------------------------------------------------------------
# IMU path
# ---------------------------------------------------------------------------


def _advance_anchor_one(params: EkfParams, fs: FilterState) -> FilterState:
    """Move the covariance anchor forward one buffer slot (lazy propagation
    overflow path — equivalent to reference per-sample cov propagation)."""
    b = params.dims.buffer_size
    idx0 = fs.anchor_buf_idx
    idx1 = (idx0 + 1) % b
    c0 = rb.get_slot(fs.buffer, idx0)
    c1 = rb.get_slot(fs.buffer, idx1)
    f_d, q_d = step_transition(c0, c1, params.imu_noise)
    cov = propagate_covariance(fs.cov, f_d, q_d)
    return dataclasses.replace(fs, cov=cov, anchor_buf_idx=idx1)


import functools


@highprec
def process_imu_impl(params: EkfParams, fs: FilterState, t, seq, w_m, a_m) -> FilterState:
    """One IMU sample: spike filter, enqueue, propagate core state."""
    t = jnp.asarray(t, fs.cov.dtype)
    w_m = jnp.asarray(w_m, fs.cov.dtype)
    a_m = jnp.asarray(a_m, fs.cov.dtype)
    b = params.dims.buffer_size
    tail = rb.get_slot(fs.buffer, fs.head)

    # accel spike filter: reuse last accel above threshold (ekf.cpp:119-128)
    spike = jnp.linalg.norm(a_m) > params.a_m_max
    a_use = jnp.where(spike & (fs.status == 2), tail.a_m, a_m)
    # failure-detection counters (spike warning ekf.cpp:119-128; missing
    # IMU sequence warning ekf.cpp:111-115)
    active = fs.status == 2
    seq_gap = active & (tail.seq >= 0) & (jnp.asarray(seq, jnp.int32) != tail.seq + 1)
    fs = dataclasses.replace(
        fs,
        n_spikes=fs.n_spikes + jnp.where(spike & active, 1, 0).astype(jnp.int32),
        n_seq_gaps=fs.n_seq_gaps + seq_gap.astype(jnp.int32),
    )

    def standby(fs):
        # place IMU data on the init state; -> kInitialized (ekf.cpp:83-99)
        core = dataclasses.replace(
            tail, time=t, seq=jnp.asarray(seq, jnp.int32), w_m=w_m, a_m=a_use
        )
        buf = rb.set_slot(fs.buffer, fs.head, core)
        # derive the new status from the old one so it keeps the same
        # varying-manual-axes type under shard_map
        return dataclasses.replace(fs, buffer=buf, status=fs.status * 0 + 2)

    def propagate(fs):
        new_core = propagate_mean(tail, t, seq, w_m, a_use, params.g_vec.astype(t.dtype))
        head1 = (fs.head + 1) % b
        buf = rb.set_slot(fs.buffer, head1, new_core)
        fs = dataclasses.replace(
            fs,
            buffer=buf,
            head=head1,
            size=jnp.minimum(fs.size + 1, b),
        )
        # keep the covariance anchor within max_update_lag of the head
        lag = rb.steps_between(fs.anchor_buf_idx, head1, b)
        return jax.lax.cond(
            lag >= params.max_update_lag,
            lambda s: _advance_anchor_one(params, s),
            lambda s: s,
            fs,
        )

    def ignore(fs):
        return fs

    return jax.lax.switch(fs.status, [ignore, standby, propagate], fs)


def _advance_anchor_n(params: EkfParams, fs: FilterState, n_adv, max_n: int) -> FilterState:
    """Advance the covariance anchor ``n_adv`` (<= max_n) buffer slots in one
    compounded covariance application — algebraically identical to ``n_adv``
    sequential :func:`_advance_anchor_one` calls."""
    b = params.dims.buffer_size
    idx_prev = (fs.anchor_buf_idx + jnp.arange(max_n, dtype=jnp.int32)) % b
    idx_next = (idx_prev + 1) % b
    c0 = rb.get_slot(fs.buffer, idx_prev)
    c1 = rb.get_slot(fs.buffer, idx_next)
    f_all, q_all = jax.vmap(lambda a, c: step_transition(a, c, params.imu_noise))(c0, c1)
    mask = (jnp.arange(max_n) < n_adv)[:, None, None]
    eye = jnp.eye(15, dtype=fs.cov.dtype)
    f_all = jnp.where(mask, f_all, eye)
    q_all = jnp.where(mask, q_all, jnp.zeros_like(q_all))
    phi, q_acc = compound_transitions(f_all, q_all)
    cov = propagate_covariance(fs.cov, phi, q_acc)
    return dataclasses.replace(
        fs, cov=cov, anchor_buf_idx=(fs.anchor_buf_idx + n_adv) % b
    )


@highprec
def process_imu_batch_impl(
    params: EkfParams, fs: FilterState, times, seqs, w_ms, a_ms
) -> FilterState:
    """Process a batch of IMU samples (the high-throughput entry point).

    The whole batch runs as ONE parallel program: last-non-spike accel
    selection (cummax gather), log-depth quaternion prefix products + v/p
    cumsums (propagate_mean_batch), a single multi-row buffer write, and
    one compounded anchor advance — equivalent to the per-sample scan
    (tested), without its serial chain. The first sample goes through the
    single-step path (which owns the standby->initialized transition);
    afterwards the status is 0 or 2, and the batched tail is selected in
    (a vmapped cond has both branches execute, so the non-taken branch
    must be cheap — a scan fallback here cost ~1.8 ms/frame dead)."""
    l = times.shape[0]
    fs = process_imu_impl(params, fs, times[0], seqs[0], w_ms[0], a_ms[0])
    if l == 1:
        return fs

    def batched_path(fs):
        b = params.dims.buffer_size
        lt = l - 1
        dtype = fs.cov.dtype
        t_b, s_b, w_b, a_b = times[1:], seqs[1:], w_ms[1:], a_ms[1:]
        tail = rb.get_slot(fs.buffer, fs.head)

        # accel spike filter: hold the last accepted accel (ekf.cpp:119-128)
        good = jnp.linalg.norm(a_b, axis=-1) <= params.a_m_max
        idx = jnp.arange(lt, dtype=jnp.int32)
        src = jax.lax.associative_scan(jnp.maximum, jnp.where(good, idx, -1))
        a_use = jnp.where(
            (src >= 0)[:, None], a_b[jnp.maximum(src, 0)], tail.a_m
        )

        # failure-detection counters (ekf.cpp:111-128)
        s_i = jnp.asarray(s_b, jnp.int32)
        expected = jnp.concatenate([tail.seq[None] + 1, s_i[:-1] + 1])
        # only the first element's predecessor is the ring tail; gate just
        # that comparison on the tail being set — intra-batch gaps always
        # count (matches the single-sample path's per-predecessor check)
        valid_prev = jnp.concatenate(
            [(tail.seq >= 0)[None], jnp.ones((lt - 1,), bool)]
        )
        gaps = jnp.sum((s_i != expected) & valid_prev).astype(jnp.int32)
        fs = dataclasses.replace(
            fs,
            n_spikes=fs.n_spikes + jnp.sum(~good).astype(jnp.int32),
            n_seq_gaps=fs.n_seq_gaps + gaps,
        )

        g = params.g_vec.astype(dtype)
        outs = propagate_mean_batch(
            tail,
            jnp.asarray(t_b, dtype),
            s_b,
            jnp.asarray(w_b, dtype),
            jnp.asarray(a_use, dtype),
            jnp.ones((lt,), bool),
            g,
        )
        rows = rb.pack_cores(outs)
        idxs = rb.ring_range(fs.head, lt, b)
        buf = fs.buffer.at[idxs].set(rows)
        head1 = (fs.head + lt) % b
        fs = dataclasses.replace(
            fs, buffer=buf, head=head1, size=jnp.minimum(fs.size + lt, b)
        )
        lag = rb.steps_between(fs.anchor_buf_idx, head1, b)
        n_adv = jnp.maximum(lag - (params.max_update_lag - 1), 0)
        return jax.lax.cond(
            n_adv > 0,
            lambda s: _advance_anchor_n(params, s, n_adv, lt),
            lambda s: s,
            fs,
        )

    return jax.lax.cond(fs.status == 2, batched_path, lambda s: s, fs)


process_imu = jax.jit(process_imu_impl, static_argnums=0)
process_imu_batch = jax.jit(process_imu_batch_impl, static_argnums=0)


# ---------------------------------------------------------------------------
# update path
# ---------------------------------------------------------------------------

UpdateFn = Callable[
    [CoreState, VisionState, jnp.ndarray],
    Tuple[CoreState, VisionState, jnp.ndarray],
]


@highprec
def _cov_at(params: EkfParams, fs: FilterState, idx) -> jnp.ndarray:
    """Propagate the anchored covariance to buffer slot ``idx`` (batched
    per-step transitions + compounding scan)."""
    dims = params.dims
    lag = params.max_update_lag
    b = dims.buffer_size
    steps = rb.steps_between(fs.anchor_buf_idx, idx, b)

    idx_prev = (fs.anchor_buf_idx + jnp.arange(lag, dtype=jnp.int32)) % b
    idx_next = (idx_prev + 1) % b
    cores_prev = rb.get_slot(fs.buffer, idx_prev)
    cores_next = rb.get_slot(fs.buffer, idx_next)

    f_all, q_all = jax.vmap(lambda c0, c1: step_transition(c0, c1, params.imu_noise))(
        cores_prev, cores_next
    )
    mask = (jnp.arange(lag) < steps)[:, None, None]
    eye = jnp.eye(15, dtype=fs.cov.dtype)
    f_all = jnp.where(mask, f_all, eye)
    q_all = jnp.where(mask, q_all, jnp.zeros_like(q_all))
    phi, q_acc = compound_transitions(f_all, q_all)
    return propagate_covariance(fs.cov, phi, q_acc)


@highprec
def _repropagate_tail(params: EkfParams, fs: FilterState, idx) -> FilterState:
    """Re-run mean propagation from the (corrected) state at ``idx`` to the
    buffer head (reference Ekf::repropagateFromStateAtIdx, ekf.cpp:227-255).

    Parallel: the quaternion chain is a log-depth prefix product and v/p
    are cumsums (propagate_mean_batch) instead of a ``lag``-step scan."""
    dims = params.dims
    lag = params.max_update_lag
    b = dims.buffer_size
    n_steps = rb.steps_between(idx, fs.head, b)
    idxs = rb.ring_range(idx, lag, b)
    samples = rb.get_slot(fs.buffer, idxs)  # stacked CoreState of tail slots
    step_mask = jnp.arange(lag) < n_steps
    g = params.g_vec.astype(fs.cov.dtype)

    start = rb.get_slot(fs.buffer, idx)
    outs = propagate_mean_batch(
        start, samples.time, samples.seq, samples.w_m, samples.a_m, step_mask, g
    )
    rows = rb.pack_cores(outs)
    buf = rb.set_rows(fs.buffer, idxs, rows, step_mask)
    return dataclasses.replace(fs, buffer=buf)


def process_update_aux_impl(
    params: EkfParams, fs: FilterState, meas_time, update_fn, aux
):
    """Like :func:`process_update` but threads an auxiliary pytree (e.g.
    track slots) through the update:
    update_fn(core, vision, cov, aux) -> (core, vision, cov, aux).
    Returns (fs, aux, applied).

    Precision note: this wrapper is deliberately NOT under ``highprec``.
    Every covariance-algebra routine it reaches (_cov_at, _apply_rows,
    sm.manage, feature init, CI fusion, propagate_covariance) carries its
    own ``highprec`` decoration; measurement-model builders (Jacobians, GN
    triangulation, track bookkeeping) run at default matmul precision —
    their ~1e-5-relative rounding perturbs only the linearization point,
    not covariance PSD-ness, and a blanket "highest" context would pay
    full-precision passes on every builder matmul."""
    b = params.dims.buffer_size
    times = rb.times(fs.buffer)
    idx = rb.closest_idx(times, jnp.asarray(meas_time, fs.cov.dtype), params.time_margin)
    anchor_t = times[fs.anchor_buf_idx]
    in_window = (
        (idx >= 0)
        & (fs.status == 2)
        & (rb.steps_between(fs.anchor_buf_idx, idx, b) < params.max_update_lag)
        & (times[jnp.maximum(idx, 0)] >= anchor_t)
    )

    def do_update(args):
        fs, aux = args
        cov_meas = _cov_at(params, fs, idx)
        core = rb.get_slot(fs.buffer, idx)
        core1, vision1, cov1, aux1 = update_fn(core, fs.vision, cov_meas, aux)
        buf = rb.set_slot(fs.buffer, idx, core1)
        fs = dataclasses.replace(
            fs, buffer=buf, cov=cov1, vision=vision1, anchor_buf_idx=idx
        )
        return _repropagate_tail(params, fs, idx), aux1

    fs, aux = jax.lax.cond(in_window, do_update, lambda a: a, (fs, aux))
    return fs, aux, in_window


process_update_aux = jax.jit(process_update_aux_impl, static_argnums=(0, 3))


@functools.partial(jax.jit, static_argnums=(0, 3))
def process_update(
    params: EkfParams, fs: FilterState, meas_time, update_fn: UpdateFn
) -> Tuple[FilterState, jnp.ndarray]:
    """Apply a measurement update at ``meas_time``.

    Reference flow (``ekf.cpp:179-255``): find closest state, propagate
    covariance there (implicit in the reference, lazy here), run the
    updater, write back, repropagate the tail. Returns (new_fs, applied?).

    Updates older than the covariance anchor (can happen for out-of-order
    collaborative measurements) are dropped, like out-of-range times.
    """
    b = params.dims.buffer_size
    times = rb.times(fs.buffer)
    idx = rb.closest_idx(times, jnp.asarray(meas_time, fs.cov.dtype), params.time_margin)
    anchor_t = times[fs.anchor_buf_idx]
    in_window = (
        (idx >= 0)
        & (fs.status == 2)
        & (rb.steps_between(fs.anchor_buf_idx, idx, b) < params.max_update_lag)
        & (times[jnp.maximum(idx, 0)] >= anchor_t)
    )

    def do_update(fs):
        cov_meas = _cov_at(params, fs, idx)
        core = rb.get_slot(fs.buffer, idx)
        core1, vision1, cov1 = update_fn(core, fs.vision, cov_meas)
        buf = rb.set_slot(fs.buffer, idx, core1)
        fs = dataclasses.replace(
            fs, buffer=buf, cov=cov1, vision=vision1, anchor_buf_idx=idx
        )
        return _repropagate_tail(params, fs, idx)

    fs = jax.lax.cond(in_window, do_update, lambda s: s, fs)
    return fs, in_window


def tail_core(fs: FilterState) -> CoreState:
    """Newest core state (for output/telemetry)."""
    return rb.get_slot(fs.buffer, fs.head)
