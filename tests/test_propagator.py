import numpy as np
import jax
import jax.numpy as jnp
from scipy.spatial.transform import Rotation
from scipy.linalg import expm

from x_multi_agent_jax.ekf import propagator
from x_multi_agent_jax.ekf.state import CoreState
from x_multi_agent_jax.ops import lie

G = np.array([0.0, 0.0, -9.81])


def make_core(rng, t=0.0):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return CoreState(
        time=jnp.asarray(t, jnp.float64),
        seq=jnp.asarray(0, jnp.int32),
        p=jnp.asarray(rng.normal(size=3)),
        v=jnp.asarray(rng.normal(size=3)),
        q=jnp.asarray(q),
        b_w=jnp.asarray(rng.normal(size=3) * 0.01),
        b_a=jnp.asarray(rng.normal(size=3) * 0.05),
        w_m=jnp.asarray(rng.normal(size=3) * 0.5),
        a_m=jnp.asarray(rng.normal(size=3) + [0, 0, 9.81]),
    )


def test_quaternion_integrator_constant_rate(rng):
    """With w constant, q1 = q0 ⊗ exp(w*dt) (Hamilton, body rate)."""
    for _ in range(5):
        q0 = rng.normal(size=4)
        q0 /= np.linalg.norm(q0)
        w = rng.normal(size=3)
        dt = 0.01
        m = propagator.quaternion_integrator(jnp.asarray(w), jnp.asarray(w), dt)
        q1 = np.array(m @ jnp.asarray(q0))
        q1 /= np.linalg.norm(q1)
        want = (Rotation.from_quat(q0) * Rotation.from_rotvec(w * dt)).as_quat()
        sign = np.sign(q1 @ want)
        np.testing.assert_allclose(q1, sign * want, atol=1e-10)


def test_quaternion_integrator_varying_rate_vs_rk4(rng):
    """Linearly interpolated w over the step: compare against fine RK4 of
    q_dot = 0.5*Omega(w(t))@q."""
    q0 = rng.normal(size=4)
    q0 /= np.linalg.norm(q0)
    w0 = rng.normal(size=3)
    w1 = w0 + rng.normal(size=3) * 0.2
    dt = 0.01

    def omega(w):
        return np.asarray(lie.omega_matrix(jnp.asarray(w)))

    # RK4 with substeps
    n_sub = 200
    q = q0.copy()
    h = dt / n_sub
    for i in range(n_sub):
        t0 = i * h
        def wt(t):
            return w0 + (w1 - w0) * (t / dt)
        k1 = 0.5 * omega(wt(t0)) @ q
        k2 = 0.5 * omega(wt(t0 + h / 2)) @ (q + h / 2 * k1)
        k3 = 0.5 * omega(wt(t0 + h / 2)) @ (q + h / 2 * k2)
        k4 = 0.5 * omega(wt(t0 + h)) @ (q + h * k3)
        q = q + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        q /= np.linalg.norm(q)

    m = propagator.quaternion_integrator(jnp.asarray(w0), jnp.asarray(w1), dt)
    got = np.array(m @ jnp.asarray(q0))
    got /= np.linalg.norm(got)
    np.testing.assert_allclose(got, q, atol=1e-9)


def test_propagate_mean_stationary():
    """Hovering: accel measures -g, zero rate -> p, v, q unchanged."""
    core = CoreState.zero(jnp.float64)
    core = jax.tree.map(lambda x: x, core)
    import dataclasses
    core = dataclasses.replace(
        core, time=jnp.asarray(0.0, jnp.float64), a_m=jnp.asarray([0.0, 0.0, 9.81])
    )
    out = propagator.propagate_mean(
        core, 0.005, 1, jnp.zeros(3), jnp.asarray([0.0, 0.0, 9.81]), jnp.asarray(G)
    )
    np.testing.assert_allclose(np.asarray(out.p), 0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out.v), 0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out.q), [0, 0, 0, 1], atol=1e-12)


def test_propagate_mean_constant_accel():
    """Level flight, constant world-frame accel: closed-form p, v."""
    import dataclasses
    core = dataclasses.replace(
        CoreState.zero(jnp.float64),
        time=jnp.asarray(0.0, jnp.float64),
        a_m=jnp.asarray([1.0, 0.0, 9.81]),
    )
    dt = 0.01
    n = 100
    for i in range(n):
        core = propagator.propagate_mean(
            core, (i + 1) * dt, i + 1, jnp.zeros(3), jnp.asarray([1.0, 0.0, 9.81]),
            jnp.asarray(G),
        )
    t = n * dt
    np.testing.assert_allclose(np.asarray(core.v), [t, 0, 0], atol=1e-9)
    np.testing.assert_allclose(np.asarray(core.p), [0.5 * t**2, 0, 0], atol=1e-9)


def _numpy_continuous(e_w, e_a, q1, noise):
    c = Rotation.from_quat(q1).as_matrix()

    def sk(v):
        return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])

    f = np.zeros((15, 15))
    f[0:3, 3:6] = np.eye(3)
    f[3:6, 6:9] = -c @ sk(e_a)
    f[3:6, 12:15] = -c
    f[6:9, 6:9] = -sk(e_w)
    f[6:9, 9:12] = -np.eye(3)
    gqg = np.zeros((15, 15))
    gqg[3:6, 3:6] = noise.n_a**2 * np.eye(3)
    gqg[6:9, 6:9] = noise.n_w**2 * np.eye(3)
    gqg[9:12, 9:12] = noise.n_bw**2 * np.eye(3)
    gqg[12:15, 12:15] = noise.n_ba**2 * np.eye(3)
    return f, gqg


def test_discrete_state_transition_vs_expm(rng):
    """Closed-form F_d is the truncated-series discretization of the
    continuous model: must match expm(F_c dt) to O(dt^3)."""
    noise = propagator.ImuNoise()
    for _ in range(5):
        e_w = rng.normal(size=3)
        e_a = rng.normal(size=3) * 5
        q1 = rng.normal(size=4)
        q1 /= np.linalg.norm(q1)
        dt = 0.002
        f_d = np.asarray(
            propagator.discrete_state_transition(
                dt, jnp.asarray(e_w), jnp.asarray(e_a), jnp.asarray(q1)
            )
        )
        f_c, _ = _numpy_continuous(e_w, e_a, q1, noise)
        # closed-form blocks truncate the series at O(dt^3): tolerance covers
        # the truncation (~|w|^3 dt^3/6 ~ 5e-9) but would catch sign/structure
        # errors (which are O(dt) ~ 1e-3).
        np.testing.assert_allclose(f_d, expm(f_c * dt), atol=3e-8)


def test_discrete_process_noise_vs_quadrature(rng):
    """Van Loan Q_d must equal the quadrature of
    int_0^dt expm(F(dt-s)) GQG expm(F(dt-s))^T ds."""
    noise = propagator.ImuNoise()
    e_w = rng.normal(size=3)
    e_a = rng.normal(size=3) * 5
    q1 = rng.normal(size=4)
    q1 /= np.linalg.norm(q1)
    dt = 0.01
    q_d = np.asarray(
        propagator.discrete_process_noise(
            dt, jnp.asarray(q1), jnp.asarray(e_w), jnp.asarray(e_a), noise
        )
    )
    f_c, gqg = _numpy_continuous(e_w, e_a, q1, noise)
    n_quad = 400
    acc = np.zeros((15, 15))
    for i in range(n_quad + 1):
        s = dt * i / n_quad
        w = 1.0 if 0 < i < n_quad else 0.5
        phi = expm(f_c * (dt - s))
        acc += w * phi @ gqg @ phi.T
    acc *= dt / n_quad
    # trapezoid quadrature itself is only ~(1/n_quad)^2 accurate; the
    # absolute floor is norm-relative — entries ~1e-5 of the dominant
    # scale are f32-roundoff-level cross terms with no physical effect
    np.testing.assert_allclose(
        q_d, acc, rtol=1e-4, atol=1e-6 * np.abs(acc).max()
    )


def test_compound_equals_stepwise(rng):
    """Compounded (Phi, Q) applied once == per-step strip propagation."""
    d = 15 + 6 * 4 + 3 * 3  # small dims
    a = rng.normal(size=(d, d))
    p0 = a @ a.T
    k = 7
    fs = np.stack([np.eye(15) + 0.01 * rng.normal(size=(15, 15)) for _ in range(k)])
    qs = []
    for _ in range(k):
        b = rng.normal(size=(15, 15)) * 0.01
        qs.append(b @ b.T)
    qs = np.stack(qs)

    # stepwise
    p_ref = p0.copy()
    for i in range(k):
        p_ref[0:15, :] = fs[i] @ p_ref[0:15, :]
        p_ref[:, 0:15] = p_ref[:, 0:15] @ fs[i].T
        p_ref[0:15, 0:15] += qs[i]

    phi, q_acc = propagator.compound_transitions(jnp.asarray(fs), jnp.asarray(qs))
    p_got = np.asarray(
        propagator.propagate_covariance(jnp.asarray(p0), phi, q_acc)
    )
    np.testing.assert_allclose(p_got, p_ref, rtol=1e-10, atol=1e-10)


def test_propagate_mean_batch_vs_scan(rng):
    """Parallel batch propagation == sequential scan of propagate_mean,
    including masked identity steps at the tail."""
    start = make_core(rng, t=1.0)
    l = 13
    times = jnp.asarray(1.0 + np.cumsum(rng.uniform(0.002, 0.01, size=l)))
    seqs = jnp.arange(l, dtype=jnp.int32)
    w_ms = jnp.asarray(rng.normal(size=(l, 3)) * 0.4)
    a_ms = jnp.asarray(rng.normal(size=(l, 3)) + [0, 0, 9.81])
    g = jnp.asarray(G)
    n_valid = 9
    valid = jnp.arange(l) < n_valid

    def body(carry, inp):
        t, s, w, a, v = inp
        t1 = jnp.where(v, t, carry.time)
        new = propagator.propagate_mean(carry, t1, s, w, a, g)
        return new, new

    _, want = jax.lax.scan(body, start, (times, seqs, w_ms, a_ms, valid))
    got = propagator.propagate_mean_batch(start, times, seqs, w_ms, a_ms, valid, g)

    for name in ("p", "v", "q"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, name))[:n_valid],
            np.asarray(getattr(want, name))[:n_valid],
            rtol=1e-10, atol=1e-12, err_msg=name,
        )
    # masked steps hold the last valid state
    np.testing.assert_allclose(
        np.asarray(got.p)[n_valid:],
        np.broadcast_to(np.asarray(want.p)[n_valid - 1], (l - n_valid, 3)),
        rtol=1e-10, atol=1e-12,
    )
    np.testing.assert_allclose(got.b_w, np.broadcast_to(start.b_w, (l, 3)))
