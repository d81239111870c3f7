"""Descriptor stack: vocabulary (incl. DBoW3 binary loading), VLAD,
keyframe database, descriptor matching, request-response round (config 5
machinery)."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from x_multi_agent_jax.place_recognition import database as db_mod
from x_multi_agent_jax.place_recognition import descriptors as desc_mod
from x_multi_agent_jax.place_recognition.vlad import compute_vlad, vlad_score
from x_multi_agent_jax.place_recognition.vocabulary import (
    Vocabulary, load_dbow3, train_kmajority, transform,
)
from x_multi_agent_jax.parallel import collab
from x_multi_agent_jax.vio import track_manager as tm

REF_VOC = "/root/reference/Vocabulary/thermal_voc_3_4_dbow3_calib.yaml"


def rand_desc(rng, n):
    return rng.integers(0, 256, (n, 32)).astype(np.uint8)


@pytest.mark.skipif(not os.path.exists(REF_VOC), reason="reference voc absent")
def test_dbow3_binary_vocabulary_loads():
    v = load_dbow3(REF_VOC)
    assert v.words.shape == (64, 32)
    assert len(np.unique(v.words, axis=0)) == 64


def test_transform_nearest_word(rng):
    words = rand_desc(rng, 16)
    # descriptors = words with a few flipped bits -> must map back
    descs = words.copy()
    descs[:, 0] ^= 1  # flip one bit each
    ids = np.array(transform(jnp.asarray(words), jnp.asarray(descs)))
    np.testing.assert_array_equal(ids, np.arange(16))


def test_kmajority_recovers_clusters(rng):
    centers = rand_desc(rng, 4)
    descs = np.repeat(centers, 50, axis=0)
    # flip ~4 random bits per descriptor
    for i in range(len(descs)):
        for _ in range(4):
            b = rng.integers(0, 256)
            descs[i, b // 8] ^= 1 << (b % 8)
    voc = train_kmajority(descs, 4, n_iters=5, seed=0)
    # every cluster center should be within a few bits of a true center
    d = np.unpackbits(voc.words[:, None, :] ^ centers[None, :, :], axis=-1).sum(-1)
    assert (d.min(axis=1) <= 4).all()


def test_vlad_properties(rng):
    words = jnp.asarray(rand_desc(rng, 8))
    descs = jnp.asarray(rand_desc(rng, 20))
    valid = jnp.ones(20, bool)
    v1 = compute_vlad(words, descs, valid)
    assert v1.shape == (8, 32) and v1.dtype == jnp.uint8
    assert float(vlad_score(v1, v1)) == 1.0
    v2 = compute_vlad(words, jnp.asarray(rand_desc(rng, 20)), valid)
    s12 = float(vlad_score(v1, v2))
    assert 0.0 < s12 < 1.0
    # invalid descriptors contribute nothing
    v3 = compute_vlad(words, descs, jnp.zeros(20, bool))
    assert int(np.array(v3).sum()) == 0


def test_knn2_matching(rng):
    da = rand_desc(rng, 12)
    perm = rng.permutation(12)
    db = da[perm].copy()
    db[:, 1] ^= 3  # two flipped bits
    idx, ok = desc_mod.knn2_match(
        jnp.asarray(da), jnp.ones(12, bool), jnp.asarray(db), jnp.ones(12, bool),
        ratio_thr=0.8, abs_thr=40.0,
    )
    inv = np.empty(12, int)
    inv[perm] = np.arange(12)
    assert bool(ok.all())
    np.testing.assert_array_equal(np.array(idx), inv)


def test_descriptor_rotation_invariance(rng):
    """Steered BRIEF must be stable under in-plane rotation of the patch."""
    from x_multi_agent_jax.vision.image import bilinear_sample
    from tests.test_vision import synth_image

    img = synth_image(rng, 96, 96, n_blobs=25)
    h, w = img.shape
    c = (w - 1) / 2.0
    theta = 0.35
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    # rotate image around center by theta
    ca, sa = np.cos(theta), np.sin(theta)
    src_x = ca * (xx - c) + sa * (yy - c) + c
    src_y = -sa * (xx - c) + ca * (yy - c) + c
    img_rot = np.array(
        bilinear_sample(jnp.asarray(img), jnp.stack([jnp.asarray(src_x), jnp.asarray(src_y)], -1))
    )

    pts = np.array([[c, c]])
    d1, ok1 = desc_mod.compute(jnp.asarray(img), jnp.asarray(pts), jnp.asarray([True]))
    d2, ok2 = desc_mod.compute(jnp.asarray(img_rot), jnp.asarray(pts), jnp.asarray([True]))
    assert bool(ok1[0]) and bool(ok2[0])
    ham = int(
        np.unpackbits(np.array(d1)[0] ^ np.array(d2)[0]).sum()
    )
    assert ham < 60, f"rotated-patch Hamming distance {ham} too large"


@pytest.mark.slow
def test_request_response_two_agents(rng):
    """Full config-5 machinery on synthetic data: agent A's keyframe DB
    answers agent B's VLAD query; descriptor-matched landmarks CI-fuse and
    shrink B's offset."""
    from tests.test_collab import run_agent, PARAMS, DIMS, TRACKS

    # deterministic per-landmark descriptors shared by both agents
    desc_table = rand_desc(rng, 40)
    words = jnp.asarray(train_kmajority(rand_desc(rng, 400), 16, 5).words)

    def run_with_desc(offset, sigma_dp, seed=1):
        from x_multi_agent_jax.utils.sim import make_circle_sim
        from x_multi_agent_jax.vio import vio as vio_mod

        sim = make_circle_sim(
            duration=3.0, imu_rate=100.0, cam_rate=10.0, n_landmarks=30,
            match_budget=TRACKS.n_matches, pixel_noise=5e-4, seed=seed,
        )
        params = PARAMS._replace(sigma_dp=(sigma_dp,) * 3)
        v = vio_mod.VIO(params)
        v.init_at_time(0.0, p=np.asarray(offset), v=np.array([1.8, 0.0, 0.0]))
        imu_i = 0
        for f, t_cam in enumerate(sim.cam_t):
            while imu_i < len(sim.imu_t) and sim.imu_t[imu_i] <= t_cam + 1e-9:
                v.process_imu(sim.imu_t[imu_i], imu_i, sim.imu_w[imu_i], sim.imu_a[imu_i])
                imu_i += 1
            ids = sim.match_id[f]
            desc = desc_table[np.clip(ids, 0, 39)]
            matches = tm.Matches.of(
                track_id=jnp.asarray(ids),
                prev_pt=jnp.asarray(sim.match_prev[f]),
                cur_pt=jnp.asarray(sim.match_cur[f]),
                valid=jnp.asarray(sim.match_valid[f]),
                desc=jnp.asarray(desc),
                desc_valid=jnp.asarray(sim.match_valid[f]),
            )
            v.process_matches_measurement(t_cam, f, matches)
        return v, sim

    va, sim = run_with_desc((0.0, 0.0, 0.0), 1e-3)
    vb, _ = run_with_desc((0.25, 0.0, 0.0), 0.5)

    ccfg = collab.CollabConfig(
        sigma_landmark=0.02, ci_slam_w=0.5, match_budget=8,
        desc_ratio_thr=0.9, desc_abs_thr=40.0, pr_score_thr=0.2,
    )
    db_dims = db_mod.DbDims(n_keyframes=4, n_words=16, max_agents=2)

    # build agent A's DB with a keyframe at the end of its run
    pa = collab.extract_payload_desc(PARAMS, va.fs, va.slots)
    db_a = db_mod.KeyframeDB.zero(db_dims, pa)
    db_a = db_mod.add_keyframe(db_dims, db_a, pa, words)
    pb = collab.extract_payload_desc(PARAMS, vb.fs, vb.slots)
    db_b = db_mod.KeyframeDB.zero(db_dims, pb)

    fs_stack = jax.tree.map(lambda x, y: jnp.stack([x, y]), va.fs, vb.fs)
    slots_stack = jax.tree.map(lambda x, y: jnp.stack([x, y]), va.slots, vb.slots)
    db_stack = jax.tree.map(lambda x, y: jnp.stack([x, y]), db_a, db_b)

    true_p = sim.cam_p[-1]
    err_before = np.linalg.norm(
        np.array(vb.tail_state().p) - true_p
    )

    fs_stack, db_stack, hits, n_matches = collab.request_response_round(
        PARAMS, ccfg, words, fs_stack, slots_stack, db_stack
    )
    hits = np.array(hits)  # [requester, responder]
    assert hits[1, 0], "B's query should hit A's keyframe"
    assert not hits[0, 1], "A should get nothing from B's empty DB"

    fs_b = jax.tree.map(lambda x: x[1], fs_stack)
    from x_multi_agent_jax.ekf import ekf as ekf_mod
    err_after = np.linalg.norm(np.array(ekf_mod.tail_core(fs_b).p) - true_p)
    assert err_after < 0.7 * err_before, (err_before, err_after, np.array(n_matches))


def test_hierarchical_vocabulary_training(rng):
    """DBoW3-parity hierarchical k-majority training (k-ary tree, leaves
    = words) + greedy tree-walk quantization: on well-separated clustered
    descriptors the tree walk must agree with the exact flat argmin over
    the leaf table."""
    from x_multi_agent_jax.place_recognition import vocabulary as v

    base = rng.integers(0, 256, (20, 32)).astype(np.uint8)
    descs = np.repeat(base, 40, axis=0)
    flips = rng.random(descs.shape + (8,)) < 0.02
    for b in range(8):
        descs ^= flips[..., b].astype(np.uint8) << b

    voc = v.train_hierarchical(descs, k=5, depth=2, seed=1)
    assert 5 <= voc.n_words <= 25
    assert (voc.word_id >= 0).sum() == voc.n_words
    # interior nodes have children; leaves have word ids
    for nid in range(1, voc.nodes.shape[0]):
        has_child = (voc.children[nid] >= 0).any()
        assert has_child != (voc.word_id[nid] >= 0)

    ids_tree = v.transform_tree(voc, descs[:100])
    ids_flat = np.asarray(
        v.transform(jnp.asarray(voc.words), jnp.asarray(descs[:100]))
    )
    assert (ids_tree == ids_flat).mean() > 0.9
