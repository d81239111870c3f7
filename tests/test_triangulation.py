import numpy as np
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from x_multi_agent_jax.ops import triangulation


def make_scene(rng, n_views, point=None):
    """Random camera trajectory looking at a world point; normalized obs."""
    if point is None:
        point = np.array([1.0, -0.5, 5.0]) + rng.normal(size=3) * 0.3
    qs, ps, obs = [], [], []
    for i in range(n_views):
        # small rotations, translating sideways (baseline)
        rot = Rotation.from_rotvec(rng.normal(size=3) * 0.05)
        p = np.array([0.4 * i, 0.1 * rng.normal(), 0.0])
        r_cw = rot.as_matrix().T
        pc = r_cw @ (point - p)
        obs.append(pc[:2] / pc[2])
        qs.append(rot.as_quat())
        ps.append(p)
    return point, np.array(qs), np.array(ps), np.array(obs)


def test_triangulation_recovers_point(rng):
    point, qs, ps, obs = make_scene(rng, 8)
    m = 12  # window larger than track: leading slots masked out
    pad = m - 8
    obs_full = np.zeros((m, 2))
    obs_full[pad:] = obs
    mask = np.zeros(m, bool)
    mask[pad:] = True
    q_full = np.zeros((m, 4))
    q_full[:, 3] = 1
    q_full[pad:] = qs
    p_full = np.zeros((m, 3))
    p_full[pad:] = ps

    ivd, anchor = triangulation.triangulate_gn(
        jnp.asarray(obs_full), jnp.asarray(mask), jnp.asarray(q_full),
        jnp.asarray(p_full),
    )
    assert int(anchor) == m - 1
    world = np.array(
        triangulation.ivd_to_world(ivd, jnp.asarray(q_full[-1]), jnp.asarray(p_full[-1]))
    )
    np.testing.assert_allclose(world, point, atol=1e-8)


def test_triangulation_noisy_matches_numpy_oracle(rng):
    """With noisy observations, the fixed-shape GN must match a ragged NumPy
    re-implementation of the reference algorithm (DLT init + GN iterations
    with the same termination rule)."""
    point, qs, ps, obs = make_scene(rng, 6)
    obs = obs + rng.normal(size=obs.shape) * 1e-3

    # ---- oracle (ragged, mirrors triangulation.cpp) ----
    rots = [Rotation.from_quat(q).as_matrix().T for q in qs]

    def proj(i):
        return np.concatenate([rots[i], -(rots[i] @ ps[i])[:, None]], axis=1)

    p1, p2 = proj(0), proj(5)
    rows = np.stack([
        obs[0, 0] * p1[2] - p1[0], obs[0, 1] * p1[2] - p1[1],
        obs[5, 0] * p2[2] - p2[0], obs[5, 1] * p2[2] - p2[1],
    ])
    _, _, vt = np.linalg.svd(rows)
    pt = vt[-1][:3] / vt[-1][3]
    pc = rots[5] @ (pt - ps[5])
    alpha, beta, rho = pc[0] / pc[2], pc[1] / pc[2], 1.0 / pc[2]
    rot_a, p_a = rots[5], ps[5]
    r_norm_last, r_norm, it = 1000.0, 100.0, 0
    while r_norm_last - r_norm > 1e-5:
        it += 1
        if it > 10:
            break
        r = np.zeros(12)
        j = np.zeros((12, 3))
        for i in range(6):
            drot = rots[i] @ rot_a.T
            dpos = rots[i] @ (p_a - ps[i])
            h = drot @ np.array([alpha, beta, 1.0]) + rho * dpos
            r[2 * i : 2 * i + 2] = obs[i] - h[:2] / h[2]
            j0 = np.stack([drot[:, 0], drot[:, 1], dpos], axis=1)
            j1 = np.array([
                [-1 / h[2], 0, h[0] / h[2] ** 2],
                [0, -1 / h[2], h[1] / h[2] ** 2],
            ])
            j[2 * i : 2 * i + 2] = j1 @ j0
        delta = np.linalg.solve(j.T @ j, j.T @ r)
        alpha, beta, rho = alpha - delta[0], beta - delta[1], rho - delta[2]
        r_norm_last, r_norm = r_norm, np.linalg.norm(r)

    ivd, _ = triangulation.triangulate_gn(
        jnp.asarray(obs), jnp.asarray(np.ones(6, bool)), jnp.asarray(qs),
        jnp.asarray(ps),
    )
    np.testing.assert_allclose(np.array(ivd), [alpha, beta, rho], rtol=1e-6, atol=1e-9)
