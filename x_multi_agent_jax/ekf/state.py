"""Filter state pytrees (behavioral spec: reference ``ekf/state.h``,
``src/x/ekf/state.cpp``).

Error-state vector layout (reference ``common/types.h:39-47`` and
``state.cpp:197-249``), total dim D = 15 + 6M + 3N:

    [ dp(3) dv(3) dtheta(3) db_w(3) db_a(3) |
      dp_arr(3M) | dtheta_arr(3M) | df_arr(3N) ]

Fixed-shape redesign vs the reference:
  * ``State`` (one object per IMU sample holding a full (D,D) covariance)
    becomes two pytrees: a tiny :class:`CoreState` that lives in the IMU-rate
    ring buffer, and a :class:`VisionState` + covariance anchored at the last
    update time. Covariance propagation is *lazy*: per-IMU-step transition
    matrices are compounded in a scan and applied to the big covariance once
    per update — algebraically identical to the reference's per-step strip
    propagation (``propagator.cpp:166-205``) because the strips compose
    linearly, but ~25x fewer large matrix ops.
  * all window bookkeeping (pose count, feature count, anchors) is fixed
    shape + masks; no dynamic allocation anywhere.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import lie


class StateDims(NamedTuple):
    """Static filter dimensions (reference defaults ``vio/types.h:141-188``)."""

    n_poses: int = 15  # M: sliding-window camera pose clones
    n_features: int = 15  # N: persistent SLAM features (inverse depth)
    buffer_size: int = 250  # B: IMU-rate ring buffer depth

    @property
    def d(self) -> int:
        """Error-state dimension 15 + 6M + 3N."""
        return 15 + 6 * self.n_poses + 3 * self.n_features

    # error-state block offsets
    @property
    def idx_p_arr(self) -> int:
        return 15

    @property
    def idx_q_arr(self) -> int:
        return 15 + 3 * self.n_poses

    @property
    def idx_f_arr(self) -> int:
        return 15 + 6 * self.n_poses


def _pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])


@_pytree_dataclass
class CoreState:
    """IMU-rate state: what propagation needs (reference ``State`` core part
    + last IMU measurement, ``state.h:242-294``)."""

    time: jnp.ndarray  # scalar; < 0 means invalid (reference kInvalid)
    seq: jnp.ndarray  # int32 scalar
    p: jnp.ndarray  # (3,)
    v: jnp.ndarray  # (3,)
    q: jnp.ndarray  # (4,) xyzw, world<-body
    b_w: jnp.ndarray  # (3,)
    b_a: jnp.ndarray  # (3,)
    w_m: jnp.ndarray  # (3,) gyro measurement at `time`
    a_m: jnp.ndarray  # (3,) accel measurement at `time`

    @staticmethod
    def zero(dtype=jnp.float32) -> "CoreState":
        z3 = jnp.zeros(3, dtype)
        return CoreState(
            time=jnp.asarray(-1.0, dtype),
            seq=jnp.asarray(-1, jnp.int32),
            p=z3,
            v=z3,
            q=lie.quat_identity(dtype),
            b_w=z3,
            b_a=z3,
            w_m=z3,
            a_m=z3,
        )


@_pytree_dataclass
class VisionState:
    """Sliding-window + SLAM-feature states, anchored at the last update.

    ``anchor_idx[j]`` is the window index of feature j's inverse-depth anchor
    pose (-1: inactive slot), mirroring ``StateManager::anchor_idxs_``.
    """

    p_arr: jnp.ndarray  # (M, 3) camera positions in world
    q_arr: jnp.ndarray  # (M, 4) camera attitudes xyzw (world<-cam)
    f_arr: jnp.ndarray  # (N, 3) inverse-depth (alpha, beta, rho)
    anchor_idx: jnp.ndarray  # (N,) int32
    n_valid_poses: jnp.ndarray  # int32 scalar, # filled window slots
    n_valid_features: jnp.ndarray  # int32 scalar, # active SLAM features

    # The window is RIGHT-aligned (fixed-shape redesign): the newest pose is always
    # at static slot M-1 and valid poses occupy slots [M - n_valid, M).
    # The reference fills left-to-right then slides; right alignment makes
    # the current-pose index static and the slide unconditional, with
    # identical filter semantics (sliding an invalid slot out is a no-op).

    @staticmethod
    def zero(dims: StateDims, dtype=jnp.float32) -> "VisionState":
        return VisionState(
            p_arr=jnp.zeros((dims.n_poses, 3), dtype),
            # empty slots hold identity quaternions: correct() renormalizes
            # every slot, and a zero quaternion would produce NaN there
            q_arr=jnp.tile(
                jnp.array([0.0, 0.0, 0.0, 1.0], dtype), (dims.n_poses, 1)
            ),
            f_arr=jnp.zeros((dims.n_features, 3), dtype),
            anchor_idx=jnp.full((dims.n_features,), -1, jnp.int32),
            n_valid_poses=jnp.asarray(0, jnp.int32),
            n_valid_features=jnp.asarray(0, jnp.int32),
        )

    def pose_mask(self, dims: StateDims) -> jnp.ndarray:
        return jnp.arange(dims.n_poses) >= dims.n_poses - self.n_valid_poses

    def feature_mask(self, dims: StateDims) -> jnp.ndarray:
        return jnp.arange(dims.n_features) < self.n_valid_features


@_pytree_dataclass
class FilterState:
    """Full filter: IMU ring buffer + update-anchored vision state/covariance.

    The ring buffer (reference ``StateBuffer``, ``state_buffer.h:31``) is a
    stacked CoreState with cyclic `head` pointing at the newest entry.
    ``anchor_buf_idx`` is the buffer slot whose time the covariance/vision
    state refer to (the last update, or the init state).
    """

    buffer: jnp.ndarray  # (B, 24) packed CoreState rows (see ekf/buffer.py)
    head: jnp.ndarray  # int32: ring index of newest entry
    size: jnp.ndarray  # int32: number of valid entries (<= B)
    anchor_buf_idx: jnp.ndarray  # int32: ring index covariance is anchored at
    cov: jnp.ndarray  # (D, D) error covariance at the anchor time
    vision: VisionState
    status: jnp.ndarray  # int32: 0 kNotInitialized / 1 kStandBy / 2 kInitialized
    # failure-detection counters (reference logs these as warnings:
    # accel spikes ekf.cpp:119-128, missing IMU sequences ekf.cpp:111-115)
    n_spikes: jnp.ndarray  # int32: accel spikes rejected so far
    n_seq_gaps: jnp.ndarray  # int32: missing IMU messages detected so far

    @staticmethod
    def zero(dims: StateDims, dtype=jnp.float32) -> "FilterState":
        from . import buffer as _rb

        buf = _rb.empty_buffer(dims.buffer_size, dtype)
        return FilterState(
            buffer=buf,
            head=jnp.asarray(0, jnp.int32),
            size=jnp.asarray(0, jnp.int32),
            anchor_buf_idx=jnp.asarray(0, jnp.int32),
            cov=jnp.zeros((dims.d, dims.d), dtype),
            vision=VisionState.zero(dims, dtype),
            status=jnp.asarray(0, jnp.int32),
            n_spikes=jnp.asarray(0, jnp.int32),
            n_seq_gaps=jnp.asarray(0, jnp.int32),
        )


# ---------------------------------------------------------------------------
# state correction (reference State::correct, state.cpp:197-249)
# ---------------------------------------------------------------------------


def correct_core(core: CoreState, correction: jnp.ndarray) -> CoreState:
    """Apply the first 15 error-state entries to a core state.

    Additive for p, v, b_w, b_a; right-multiplicative error quaternion for q
    (reference ``state.cpp:224-229``).
    """
    dq = lie.error_quat_from_small_angles(correction[6:9])
    return dataclasses.replace(
        core,
        p=core.p + correction[0:3],
        v=core.v + correction[3:6],
        q=lie.quat_normalize(lie.quat_multiply(core.q, dq)),
        b_w=core.b_w + correction[9:12],
        b_a=core.b_a + correction[12:15],
    )


def correct_vision(
    vision: VisionState, correction: jnp.ndarray, dims: StateDims
) -> VisionState:
    """Apply window/feature error-state entries (reference ``state.cpp:230-249``)."""
    m, n = dims.n_poses, dims.n_features
    dp_arr = correction[dims.idx_p_arr : dims.idx_p_arr + 3 * m].reshape(m, 3)
    dth_arr = correction[dims.idx_q_arr : dims.idx_q_arr + 3 * m].reshape(m, 3)
    df_arr = correction[dims.idx_f_arr : dims.idx_f_arr + 3 * n].reshape(n, 3)
    dq_arr = lie.error_quat_from_small_angles(dth_arr)
    return dataclasses.replace(
        vision,
        p_arr=vision.p_arr + dp_arr,
        q_arr=lie.quat_normalize(lie.quat_multiply(vision.q_arr, dq_arr)),
        f_arr=vision.f_arr + df_arr,
    )


# ---------------------------------------------------------------------------
# camera pose composition (reference state.cpp:184-195)
# ---------------------------------------------------------------------------


def camera_orientation(core: CoreState, q_ic: jnp.ndarray) -> jnp.ndarray:
    return lie.quat_normalize(lie.quat_multiply(core.q, q_ic))


def camera_position(core: CoreState, p_ic: jnp.ndarray) -> jnp.ndarray:
    return core.p + lie.quat_to_rot(core.q) @ p_ic
