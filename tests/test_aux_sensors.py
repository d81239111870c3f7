"""Range-facet and solar updates (config 3): geometry + finite-difference
Jacobian checks against independent NumPy predictions."""
import numpy as np
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from x_multi_agent_jax.ekf.state import StateDims
from x_multi_agent_jax.vio.range_facet import feature_triangle_at_point
from x_multi_agent_jax.vio.updates import range as range_upd
from x_multi_agent_jax.vio.updates import solar
from x_multi_agent_jax.ops import lie

DIMS = StateDims(n_poses=5, n_features=6, buffer_size=16)


def test_facet_selection_simple():
    pts = jnp.asarray(
        [[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [2.0, 2.0], [-1.0, -1.0], [0.5, 2.0]]
    )
    valid = jnp.asarray([True] * 6)
    ids, found = feature_triangle_at_point(pts, valid, jnp.asarray([0.2, 0.2]))
    assert bool(found)
    assert set(np.array(ids).tolist()) == {0, 1, 2}  # smallest containing triangle
    # outside all triangles
    _, found2 = feature_triangle_at_point(pts, valid, jnp.asarray([10.0, 10.0]))
    assert not bool(found2)


def _setup_scene(rng):
    m, n = DIMS.n_poses, DIMS.n_features
    q_arr = np.zeros((m, 4))
    p_arr = np.zeros((m, 3))
    for i in range(m):
        q = Rotation.from_rotvec(rng.normal(size=3) * 0.05).as_quat()
        q_arr[i] = q
        p_arr[i] = rng.normal(size=3) * 0.3
    f_arr = np.zeros((n, 3))
    anchor = rng.integers(0, m, n)
    for j in range(n):
        f_arr[j] = [rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3), rng.uniform(0.1, 0.25)]
    return q_arr, p_arr, f_arr, anchor.astype(np.int32)


def _predict_range_np(q_arr, p_arr, f_arr, anchor, ids, img_pt, cur):
    """Independent prediction: ray-plane intersection."""
    lms = []
    for j in ids:
        a = anchor[j]
        r_wa = Rotation.from_quat(q_arr[a]).as_matrix()
        al, be, rho = f_arr[j]
        lms.append(r_wa @ np.array([al, be, 1.0]) / rho + p_arr[a])
    lms = np.array(lms)
    nrm = np.cross(lms[0] - lms[1], lms[2] - lms[1])
    r_wc = Rotation.from_quat(q_arr[cur]).as_matrix()
    d = r_wc @ np.array([img_pt[0], img_pt[1], 1.0])
    # (p_c + t d - lms[1]) . n = 0
    t = (lms[1] - p_arr[cur]) @ nrm / (d @ nrm)
    return t


def test_range_jacobian_finite_difference(rng):
    q_arr, p_arr, f_arr, anchor = _setup_scene(rng)
    cur = DIMS.n_poses - 1
    ids = np.array([0, 1, 2], np.int32)
    img_pt = np.array([0.05, -0.03])
    r_true = _predict_range_np(q_arr, p_arr, f_arr, anchor, ids, img_pt, cur)

    d = DIMS.d
    cov = jnp.eye(d) * 1e-4

    def rows_for(qa, pa, fa):
        return range_upd.build(
            r_true, jnp.asarray(img_pt), jnp.asarray(ids), jnp.asarray(fa),
            jnp.asarray(anchor), jnp.asarray(qa), jnp.asarray(pa), cov, cur,
            sigma_range=0.05, active=jnp.asarray(True),
        )

    out = rows_for(q_arr, p_arr, f_arr)
    assert abs(float(out.res[0])) < 1e-9  # consistent measurement -> 0 residual
    jac = np.array(out.jac[0])

    eps = 1e-6
    m = DIMS.n_poses

    def num_grad(perturb):
        """central difference of the *residual* wrt error-state direction."""
        qa1, pa1, fa1 = perturb(+eps)
        qa2, pa2, fa2 = perturb(-eps)
        r1 = float(rows_for(qa1, pa1, fa1).res[0])
        r2 = float(rows_for(qa2, pa2, fa2).res[0])
        return (r1 - r2) / (2 * eps)

    # current camera position error, axis 0 (error col 15 + 3*cur)
    def pert_pos(e):
        pa = p_arr.copy()
        pa[cur, 0] += e
        return q_arr, pa, f_arr

    g = num_grad(pert_pos)
    # res = z - h  =>  d res / dx = -H
    np.testing.assert_allclose(-g, jac[15 + 3 * cur], rtol=1e-4, atol=1e-7)

    # current camera attitude error, axis 2
    def pert_att(e):
        qa = q_arr.copy()
        dq = np.array(lie.error_quat_from_small_angles(jnp.asarray([0.0, 0.0, e])))
        qa[cur] = np.array(lie.quat_multiply(jnp.asarray(q_arr[cur]), jnp.asarray(dq)))
        return qa, p_arr, f_arr

    g = num_grad(pert_att)
    np.testing.assert_allclose(-g, jac[15 + 3 * m + 3 * cur + 2], rtol=1e-4, atol=1e-7)

    # feature 1 inverse-depth rho error (error col 15+6m+3*1+2)
    def pert_rho(e):
        fa = f_arr.copy()
        fa[1, 2] += e
        return q_arr, p_arr, fa

    g = num_grad(pert_rho)
    np.testing.assert_allclose(-g, jac[15 + 6 * m + 3 * 1 + 2], rtol=1e-4, atol=1e-7)

    # anchor position of feature 0, axis 1
    def pert_anchor(e):
        pa = p_arr.copy()
        pa[anchor[0], 1] += e
        return q_arr, pa, f_arr

    # note: anchor perturbation also moves camera if anchor == cur; exclude
    if anchor[0] != cur:
        g = num_grad(pert_anchor)
        np.testing.assert_allclose(
            -g, jac[15 + 3 * int(anchor[0]) + 1], rtol=1e-4, atol=1e-7
        )


def test_solar_update_zero_residual_and_fd(rng):
    d = DIMS.d
    cov = jnp.eye(d) * 1e-4
    q_imu = Rotation.from_rotvec(rng.normal(size=3) * 0.3).as_quat()
    calib = solar.SolarCalib()

    # consistent measurement: predict with numpy
    r_si = Rotation.from_quat(np.asarray(calib.q_si)).as_matrix()
    sun_w = np.asarray(calib.sun_w)
    sun_w = sun_w / np.linalg.norm(sun_w)
    s = r_si.T @ Rotation.from_quat(q_imu).as_matrix().T @ sun_w
    s = s / np.linalg.norm(s)
    ang = solar.RAD2DEG * np.array([np.arctan2(s[0], s[2]), np.arctan2(s[1], s[2])])

    out = solar.build(jnp.asarray(ang), jnp.asarray(q_imu), cov, jnp.asarray(True))
    np.testing.assert_allclose(np.array(out.res), 0, atol=1e-6)

    # central-difference the attitude Jacobian (cols 6:9): H = d pred/d dth
    def pred(q):
        sv = r_si.T @ Rotation.from_quat(q).as_matrix().T @ sun_w
        sv = sv / np.linalg.norm(sv)
        return solar.RAD2DEG * np.array(
            [np.arctan2(sv[0], sv[2]), np.arctan2(sv[1], sv[2])]
        )

    jac = np.array(out.jac)[:, 6:9]
    eps = 1e-6
    for axis in range(3):
        dth = np.zeros(3)
        dth[axis] = eps
        dq = np.array(lie.error_quat_from_small_angles(jnp.asarray(dth)))
        qp = np.array(lie.quat_multiply(jnp.asarray(q_imu), jnp.asarray(dq)))
        dqm = np.array(lie.error_quat_from_small_angles(jnp.asarray(-dth)))
        qm = np.array(lie.quat_multiply(jnp.asarray(q_imu), jnp.asarray(dqm)))
        g = (pred(qp) - pred(qm)) / (2 * eps)
        np.testing.assert_allclose(g, jac[:, axis], rtol=1e-6, atol=1e-7)


def test_per_feature_range_jacobian_finite_difference(rng):
    """Per-feature LRF variant (range_update.cpp:267-407, unused in the
    reference — parity completeness): residual and every Jacobian block
    verified by central differences, including the anchor == current-pose
    special case where the pose terms cancel to the single -1/rho^2
    column."""
    q_arr, p_arr, f_arr, anchor = _setup_scene(rng)
    cur = DIMS.n_poses - 1
    m = DIMS.n_poses
    d = DIMS.d
    cov = jnp.eye(d) * 1e-4
    feat = 1
    # exercise BOTH branches: general anchor, then anchor == cur
    for a_override in (int(anchor[feat]) % (m - 1), cur):
        anc = anchor.copy()
        anc[feat] = a_override

        def predict(qa, pa, fa):
            r_wa = Rotation.from_quat(qa[anc[feat]]).as_matrix()
            al, be, rho = fa[feat]
            g_p_f = r_wa @ np.array([al, be, 1.0]) / rho + pa[anc[feat]]
            r_wc = Rotation.from_quat(qa[cur]).as_matrix()
            return float((r_wc.T @ (g_p_f - pa[cur]))[2])

        r_true = predict(q_arr, p_arr, f_arr)

        def rows_for(qa, pa, fa):
            return range_upd.build_per_feature(
                r_true, jnp.asarray(feat), jnp.asarray(fa),
                jnp.asarray(anc), jnp.asarray(qa), jnp.asarray(pa), cov,
                cur, sigma_range=0.05, active=jnp.asarray(True),
            )

        out = rows_for(q_arr, p_arr, f_arr)
        assert abs(float(out.res[0])) < 1e-9
        jac = np.array(out.jac[0])
        eps = 1e-6

        def num_grad(perturb):
            qa1, pa1, fa1 = perturb(+eps)
            qa2, pa2, fa2 = perturb(-eps)
            return (
                float(rows_for(qa1, pa1, fa1).res[0])
                - float(rows_for(qa2, pa2, fa2).res[0])
            ) / (2 * eps)

        # current pose position (z axis)
        def pert_pos(e):
            pa = p_arr.copy()
            pa[cur, 2] += e
            return q_arr, pa, f_arr

        np.testing.assert_allclose(
            -num_grad(pert_pos), jac[15 + 3 * cur + 2], rtol=1e-4, atol=1e-7
        )

        # current attitude (axis 1)
        def pert_att(e):
            qa = q_arr.copy()
            dq = np.array(
                lie.error_quat_from_small_angles(jnp.asarray([0.0, e, 0.0]))
            )
            qa[cur] = np.array(
                lie.quat_multiply(jnp.asarray(q_arr[cur]), jnp.asarray(dq))
            )
            return qa, p_arr, f_arr

        np.testing.assert_allclose(
            -num_grad(pert_att), jac[15 + 3 * m + 3 * cur + 1],
            rtol=1e-4, atol=1e-7,
        )

        # feature inverse depth rho
        def pert_rho(e):
            fa = f_arr.copy()
            fa[feat, 2] += e
            return q_arr, p_arr, fa

        np.testing.assert_allclose(
            -num_grad(pert_rho), jac[15 + 6 * m + 3 * feat + 2],
            rtol=1e-4, atol=1e-7,
        )

        if a_override != cur:
            # anchor position (axis 0)
            def pert_anchor(e):
                pa = p_arr.copy()
                pa[a_override, 0] += e
                return q_arr, pa, f_arr

            np.testing.assert_allclose(
                -num_grad(pert_anchor), jac[15 + 3 * a_override],
                rtol=1e-4, atol=1e-7,
            )
        else:
            # special case: pose blocks cancel; only the feature column
            # survives, with d(range)/d(rho) = -1/rho^2
            assert np.allclose(jac[15 + 3 * cur : 15 + 3 * cur + 3], 0.0,
                               atol=1e-9)
            assert np.allclose(
                jac[15 + 3 * m + 3 * cur : 15 + 3 * m + 3 * cur + 3], 0.0,
                atol=1e-9,
            )
            rho = f_arr[feat, 2]
            np.testing.assert_allclose(
                jac[15 + 6 * m + 3 * feat + 2], -1.0 / rho**2, rtol=1e-9
            )
