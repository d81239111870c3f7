"""Trajectory-level collaborative gain (reference headline metric:
'improves trajectory estimates up to 46%', README.md:97-98). The degraded
agent's full-trajectory ATE must drop substantially once periodic
exchange rounds run, and the helper agent must stay accurate."""
import pytest

from x_multi_agent_jax.utils.collab_eval import run_collab_gain
from tests.test_collab import PARAMS, CCFG


@pytest.mark.slow
def test_collaborative_ate_gain():
    res = run_collab_gain(PARAMS, CCFG)
    assert res.n_matches > 0, "no cross-agent matches applied"
    # solo: the init offset is gauge-unobservable, ATE stays ~offset-sized
    assert res.ate_solo > 0.1, res
    # collaborative: at least the reference's 46% headline gain
    assert res.gain > 0.46, res
    # the well-initialized helper is not dragged away by CI fusion
    assert res.ate_helper < 0.1, res


@pytest.mark.slow
def test_collaborative_nees_consistency():
    """Collab-path consistency gate (round-2 VERDICT item 3): the degraded
    agent's mean position NEES during the collaborative run must stay
    inside a chi2(3) band — CI fusion exists precisely to preserve
    consistency under unknown cross-correlation (ci.cpp:16-47)."""
    res = run_collab_gain(PARAMS, CCFG)
    assert res.gain > 0.46, res
    assert 0.2 < res.mean_nees_collab < 5.0, res


@pytest.mark.slow
def test_collaborative_gain_adaptive_weights():
    """Negative ci_slam_w = on-line det-minimizing weight (reference NLopt
    convention): must keep the gain and helper accuracy AND stay
    chi2-consistent. The adaptive weight is what prevents a fleet from
    drifting into consensus with its worst member on long runs."""
    res = run_collab_gain(PARAMS, CCFG._replace(ci_slam_w=-0.05))
    assert res.gain > 0.46, res
    assert res.ate_helper < 0.1, res
    assert 0.2 < res.mean_nees_collab < 5.0, res
