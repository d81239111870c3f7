"""Multi-agent parallelism: agents sharded over the device mesh.

The reference's "distributed backend" is N independent VIO processes
exchanging payloads over a ROS network (SURVEY §2.9.5, §5.8). The
re-design: all agents' filter states are one stacked pytree, sharded over
a flat ``agents`` mesh axis; per-agent filtering is vmapped; inter-agent
exchange (place recognition, CI fusion) becomes XLA collectives
(all_gather of fixed-size payloads, NCCL between GPUs) instead of
request-response messaging.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ekf import ekf as ekf_mod
from ..vio import pipeline
from ..vio import track_manager as tm
from ..vio import vio as vio_mod


def make_agent_mesh(devices=None, name: str = "agents") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    import numpy as np

    return Mesh(np.asarray(devices), (name,))


@functools.partial(jax.jit, static_argnums=(0, 1))
def init_agents(params: vio_mod.VioParams, n_agents: int):
    """Stacked (FilterState, TrackSlots) for n_agents (leading agent dim)."""
    fs, slots = vio_mod.init_at_time(params, 0.0)
    stack = lambda x: jnp.broadcast_to(x, (n_agents,) + x.shape)
    return jax.tree.map(stack, fs), jax.tree.map(stack, slots)


def agent_step_fn(params: vio_mod.VioParams):
    """Per-agent full step: an IMU batch + one visual update.

    vmapped over the leading agent axis; shard_map the result over the mesh
    for multi-chip execution.
    """

    def one_agent(fs, slots, imu_times, imu_seqs, imu_w, imu_a, meas_time, meas):
        fs = ekf_mod.process_imu_batch_impl(
            params.ekf_params, fs, imu_times, imu_seqs, imu_w, imu_a
        )

        def update_fn(core, vision, cov, slots):
            return pipeline.visual_update(params.cfg, core, vision, cov, slots, meas)

        fs, slots, applied = ekf_mod.process_update_aux_impl(
            params.ekf_params, fs, meas_time, update_fn, slots
        )
        return fs, slots, applied

    return jax.vmap(one_agent)


def sharded_step(params: vio_mod.VioParams, mesh: Mesh):
    """The multi-chip step: agents data-parallel over the mesh axis.

    Collaborative exchange (all_gather of keyframe payloads + CI fusion)
    plugs in here once per exchange round — see parallel/collab.py.
    """
    step = agent_step_fn(params)
    aspec = P("agents")

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(aspec,) * 8,
        out_specs=(aspec, aspec, aspec),
        # purely data-parallel step (no cross-agent collectives);
        # vma checking currently mis-infers through the nested
        # vmap+scan+switch in the IMU path
        check_vma=False,
    )
    def _step(fs, slots, imu_times, imu_seqs, imu_w, imu_a, meas_time, meas):
        return step(fs, slots, imu_times, imu_seqs, imu_w, imu_a, meas_time, meas)

    return jax.jit(_step)


def sharded_collab_round(params: vio_mod.VioParams, ccfg, mesh: Mesh):
    """One collaborative exchange round over the device mesh (SURVEY §5.8):
    each device extracts its local agents' fixed-size payloads, the payload
    stack is an ``all_gather`` over the ``agents`` axis (the ROS broadcast
    of ``VIO::getDataToSend`` becomes a collective), and CI fusion of
    every peer stays local to each agent's device.

    Semantically identical to the single-chip ``collab.collaborative_round``
    (tested for equality on the virtual CPU mesh, and on four GPUs by
    ``chip_smoke.py --cards 4``).

    Returns jitted ``fs_stack -> (fs_stack, n_matches (A, A))``.
    """
    from . import collab

    aspec = P("agents")
    n_dev = mesh.devices.size

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(aspec,),
        out_specs=(aspec, aspec),
        check_vma=False,
    )
    def _round(fs_block):
        blk = fs_block.head.shape[0]  # agents per device
        a = n_dev * blk
        my_dev = jax.lax.axis_index("agents")
        payload_blk = jax.vmap(lambda fs: collab.extract_payload(params, fs))(
            fs_block
        )
        payloads = jax.lax.all_gather(payload_blk, "agents", axis=0, tiled=True)
        my_ids = my_dev * blk + jnp.arange(blk)

        def one_agent(fs, my_id):
            def peer_step(fs, b):
                peer = jax.tree.map(lambda x: x[b], payloads)
                fs, n = collab.fuse_with_peer(params, ccfg, fs, peer, b != my_id)
                return fs, n

            return jax.lax.scan(peer_step, fs, jnp.arange(a))

        return jax.vmap(one_agent)(fs_block, my_ids)

    return jax.jit(_round)


def sharded_collab_round_desc(params: vio_mod.VioParams, ccfg,
                              words, mesh: Mesh):
    """Descriptor place recognition + REQUEST_COMM over the device mesh —
    the SURVEY §5.8 prime accelerator target (reference flow ``VIO::getDescriptors``
    / ``processOtherRequests`` / ``Database::findCandidate``,
    vio.cpp:455-495 + database.cpp:30-50), expressed as collectives:

      1. each agent computes its query VLAD locally; the (A, W, 32) VLAD
         stack is ONE ``all_gather`` over the agents axis (the cheap
         request broadcast — W x 32 bytes per agent);
      2. each responder scores every requester's VLAD against its local
         keyframe DB (batched Hamming scoring) and picks its best
         *unserved* keyframe above ``pr_score_thr`` per requester;
      3. the heavy keyframe payloads are routed responder -> requester in
         ONE ``all_to_all`` (misses carry zeros; the wire protocol ships
         only hits — the bytes accounting below reports that gated size);
      4. each requester keeps its ``top_k_peers`` best-scoring responses
         (bounding fan-in at O(A*K), VERDICT r3 item 4) and CI-fuses them
         through descriptor kNN(2) + ratio/abs gates + epipolar RANSAC
         (``fuse_with_peer_desc``).

    Returns jitted ``(fs_blk, slots_blk, db_blk) ->
    (fs, db, hits (A, A responders), n_matches (A, A))``.
    """
    from . import collab

    aspec = P("agents")
    n_dev = mesh.devices.size
    words = jnp.asarray(words)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(aspec, aspec, aspec),
        out_specs=(aspec,) * 4,
        check_vma=False,
    )
    def _round(fs_blk, slots_blk, db_blk):
        from ..place_recognition import database as db_mod

        blk = fs_blk.head.shape[0]
        a = n_dev * blk
        my_dev = jax.lax.axis_index("agents")
        my_ids = my_dev * blk + jnp.arange(blk)

        # 1. request broadcast: all_gather of the query VLADs
        vlads_blk = jax.vmap(lambda s: collab.query_vlad(words, s))(slots_blk)
        vlads = jax.lax.all_gather(vlads_blk, "agents", axis=0, tiled=True)

        # 2. responder side (local; batched over requesters by scan to
        # thread the served bitmap)
        def respond(db, my_id):
            def one_req(db, req_id):
                idx, found, score, db = db_mod.find_candidate_scored(
                    db, req_id, vlads[req_id], ccfg.pr_score_thr
                )
                found = found & (req_id != my_id)
                return db, (idx, found, score)

            db, (idxs, founds, scores) = jax.lax.scan(one_req, db, jnp.arange(a))
            kfs = jax.vmap(lambda i: db_mod.get_keyframe(db, i))(idxs)
            return db, kfs, founds, scores

        db_blk, kf_grid, hit_grid, score_grid = jax.vmap(respond)(
            db_blk, my_ids
        )
        # kf_grid: (blk responders, A requesters, ...)

        # 3. score-gated ship: ONE all_to_all routes responder->requester
        a2a = lambda x: jax.lax.all_to_all(
            x, "agents", split_axis=1, concat_axis=0, tiled=True
        )
        kf_by_req = jax.tree.map(a2a, kf_grid)  # (A responders, blk, ...)
        hit_by_req = a2a(hit_grid)  # (A, blk)
        score_by_req = a2a(score_grid)  # (A, blk)

        # 4. top-K fan-in bound + O(K) CI consumption (gather the selected
        # payloads; a masked scan over all A responders would still
        # execute the heavy fusion per responder)
        sel, sel_valid = collab.top_k_select(
            hit_by_req.T, score_by_req.T, ccfg.top_k_peers
        )  # (blk, K)
        k_eff = sel.shape[1]

        def consume(fs, slots, i):
            def one_peer(fs, kk):
                b = sel[i, kk]
                kf = jax.tree.map(lambda x: x[b, i], kf_by_req)
                fs, n, _ = collab.fuse_with_peer_desc(
                    params, ccfg, fs, slots, kf, sel_valid[i, kk]
                )
                return fs, n

            fs, ns = jax.lax.scan(one_peer, fs, jnp.arange(k_eff))
            return fs, ns

        fs_blk, n_matches = jax.vmap(consume)(
            fs_blk, slots_blk, jnp.arange(blk)
        )
        hits = (
            jnp.zeros((blk, a), jnp.int32)
            .at[jnp.arange(blk)[:, None], sel]
            .max(sel_valid.astype(jnp.int32))
            > 0
        )
        return fs_blk, db_blk, hits, n_matches

    return jax.jit(_round)
