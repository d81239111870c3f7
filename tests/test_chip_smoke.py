"""chip_smoke.py's phases and checks, run on the CPU at small size.

The script itself refuses to run without a GPU; its phases are plain
functions, so their comparisons (solve residuals against the Cholesky
oracle, the sharded fleet against one device) are exercised here.
"""
import numpy as np
import pytest

import __graft_entry__ as ge
import chip_smoke


def test_device_phase_refuses_cpu():
    with pytest.raises(SystemExit):
        chip_smoke.phase_device(1)


def test_innovation_batch_spans_condition_numbers():
    s, b, kappa = chip_smoke.innovation_batch(6, 21, 1e2, 1e6)
    assert s.shape == (6, 21, 21) and b.shape == (6, 21, 20)
    np.testing.assert_allclose(np.linalg.cond(s), kappa, rtol=1e-6)
    assert (np.linalg.eigvalsh(s) >= 1.0 - 1e-9).all()  # S = H P H^T + I


def test_solve_phase_passes_small():
    chip_smoke.phase_solve(batch=8, n=61)


def _fleet(n=4):
    rng = np.random.default_rng(0)
    return dict(
        applied=np.ones((3, n), bool), n_full=np.full((n, n), 2),
        hits=np.eye(n, dtype=bool)[::-1], n_desc=np.ones((n, 3), int),
        p=rng.normal(size=(n, 3)), cov=np.tile(np.eye(5), (n, 1, 1)),
    )


@pytest.mark.parametrize("field, change", [
    ("n_full", lambda x: x + np.eye(len(x), dtype=int)),
    ("hits", lambda x: ~x),
    ("p", lambda x: x + 2e-4),
    ("cov", lambda x: x * (1 + 2e-4)),
])
def test_compare_fleets_rejects_a_difference(field, change):
    one = _fleet()
    chip_smoke.compare_fleets(one, dict(one))
    other = dict(one)
    other[field] = change(one[field])
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.compare_fleets(one, other)


def test_mesh_phase_matches_one_device():
    # 8 agents on 4 of the 8 virtual CPU devices, small filter dimensions
    chip_smoke.phase_mesh(ge._params(small=True), 4, n_agents=8)
