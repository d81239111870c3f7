"""Mesh-native descriptor REQUEST_COMM round vs the single-chip form.

`parallel.mesh.sharded_collab_round_desc` (VLAD all_gather -> batched DB
scoring -> score-gated all_to_all of keyframe payloads -> top-K CI
consumption) must equal `parallel.collab.request_response_round` on
identical inputs — the collective layout (all_to_all split/concat axes,
requester/responder orientation, top-K gather indices) is exactly what a
hits>0 smoke test cannot catch.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from x_multi_agent_jax.parallel import collab
from x_multi_agent_jax.place_recognition import database as db_mod
from x_multi_agent_jax.place_recognition.vocabulary import train_kmajority

from tests.test_collab import PARAMS, CCFG, run_agent


def _with_descriptors(slots, desc_table):
    """Inject per-landmark descriptors keyed by track id (sim track ids ARE
    landmark indices, shared across agents)."""
    n_lm = desc_table.shape[0]
    sid = np.maximum(np.asarray(slots.slam_id), 0) % n_lm
    oid = np.maximum(np.asarray(slots.opp_id), 0) % n_lm
    return dataclasses.replace(
        slots,
        slam_desc=jnp.asarray(desc_table[sid]),
        slam_desc_valid=jnp.asarray(np.asarray(slots.slam_id) >= 0),
        opp_desc=jnp.asarray(desc_table[oid]),
        opp_desc_valid=jnp.asarray(np.asarray(slots.opp_id) >= 0),
    )


@pytest.mark.slow
def test_sharded_desc_round_matches_single_chip():
    rng = np.random.default_rng(5)
    desc_table = rng.integers(0, 256, (40, 32)).astype(np.uint8)
    words = jnp.asarray(train_kmajority(desc_table, 8, 4).words)

    va, _ = run_agent((0.0, 0.0, 0.0), 1e-3)
    vb, _ = run_agent((0.25, 0.0, 0.0), 0.5)
    fs_stack = jax.tree.map(lambda x, y: jnp.stack([x, y]), va.fs, vb.fs)
    sa = _with_descriptors(va.slots, desc_table)
    sb = _with_descriptors(vb.slots, desc_table)
    slots_stack = jax.tree.map(lambda x, y: jnp.stack([x, y]), sa, sb)

    ccfg = CCFG._replace(
        desc_ratio_thr=0.85, desc_abs_thr=60.0, pr_score_thr=0.05,
        pr_ransac_thr=0.0, top_k_peers=1, ci_slam_w=0.05,
    )
    db_dims = db_mod.DbDims(n_keyframes=3, n_words=int(words.shape[0]),
                            max_agents=2)

    def build_db(fs, slots):
        proto = collab.extract_payload_desc(PARAMS, fs, slots)
        db = db_mod.KeyframeDB.zero(db_dims, jax.tree.map(jnp.zeros_like, proto))
        return db_mod.add_keyframe(db_dims, db, proto, words)

    db_a = build_db(va.fs, sa)
    db_b = build_db(vb.fs, sb)
    db_stack = jax.tree.map(lambda x, y: jnp.stack([x, y]), db_a, db_b)

    ref_fs, ref_db, ref_hits, ref_nm = collab.request_response_round(
        PARAMS, ccfg, words, fs_stack, slots_stack, db_stack
    )

    from x_multi_agent_jax.parallel import mesh as pmesh

    mesh = pmesh.make_agent_mesh(jax.devices()[:2])
    round_fn = pmesh.sharded_collab_round_desc(PARAMS, ccfg, words, mesh)
    got_fs, got_db, got_hits, got_nm = round_fn(fs_stack, slots_stack, db_stack)

    assert int(np.asarray(ref_hits).sum()) > 0, "no hits — test is vacuous"
    np.testing.assert_array_equal(np.asarray(got_hits), np.asarray(ref_hits))
    np.testing.assert_array_equal(np.asarray(got_nm), np.asarray(ref_nm))
    for ref, got in zip(jax.tree.leaves(ref_fs), jax.tree.leaves(got_fs)):
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(ref), rtol=1e-12, atol=1e-12
        )
    for ref, got in zip(jax.tree.leaves(ref_db), jax.tree.leaves(got_db)):
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(ref), rtol=1e-12, atol=1e-12
        )
    # the number of CI-fused matches must be nonzero through the mesh path
    assert int(np.asarray(got_nm).sum()) > 0
