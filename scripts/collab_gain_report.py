"""Collaborative-gain report: trajectory ATE of a degraded agent, solo vs
with periodic full-map exchange rounds (reference headline: up to 46%
improvement, README.md:97-98). Prints one JSON line."""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# float64 on CPU (same setup as tests/conftest.py)
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from x_multi_agent_jax.parallel import collab
from x_multi_agent_jax.utils.collab_eval import run_collab_gain
from tests.test_collab import PARAMS, CCFG


def main():
    res = run_collab_gain(PARAMS, CCFG)
    print(
        json.dumps(
            {
                "metric": "collab_ate_gain",
                "ate_solo_m": round(res.ate_solo, 4),
                "ate_collab_m": round(res.ate_collab, 4),
                "ate_helper_m": round(res.ate_helper, 4),
                "gain_pct": round(100 * res.gain, 1),
                "exchange_rounds": res.n_rounds,
                "cross_agent_matches": res.n_matches,
                "reference_claim_pct": 46.0,
            }
        )
    )


if __name__ == "__main__":
    main()
