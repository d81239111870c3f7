"""Smoke test of the collaborative VIO main path on a GPU.

    python chip_smoke.py            # one card
    python chip_smoke.py --cards 4  # the agents mesh over four cards

One card runs these phases in order and stops at the first failure:

  device   JAX's devices, backend, XLA_FLAGS and the card's name and power
           limit; anything but a GPU fails.
  filter   the match-driven fleet step as ``bench.bench_matches`` builds it
           at full dimensions (M=15, N=15, D=150, 200 matches, lag 16), at
           128 and 512 agents for 20 frames each, then the batch-1 step,
           with the bench's gate-health asserts.
  solve    ``linalg.spd_solve`` on 128 SPD 151x151 innovation matrices
           (condition 1e2..1e6) against the float32 Cholesky oracle.
  image    the full image pipeline as ``bench.bench_image`` builds it
           (480x640 orbit frames, pyramid -> LK -> RANSAC -> gated FAST ->
           fused update) at 16 agents for 20 frames.
  lk       the Triton LK kernel against the plain-JAX levels at 16 agents x
           200 features on the 480x640 pyramid.
  facade   one vehicle through ``vio.VIO`` at full dimensions: IMU sample by
           sample and 40 rendered 480x640 frames.

``--cards 4`` runs only the mesh phase: ``parallel.mesh``'s sharded step,
full-map exchange round and descriptor request-response round over four
cards, compared with the same 16 agents on one card.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import argparse
import json
import os
import sys
import time

import numpy as np


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase_device(n_cards: int) -> dict:
    import jax

    print(f"devices: {jax.devices()}", flush=True)
    print(f"backend: {jax.default_backend()}", flush=True)
    print(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')}", flush=True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"FAIL device: JAX runs on {dev.platform!r}, not a GPU")
    if len(jax.devices()) < n_cards:
        sys.exit(f"FAIL device: {n_cards} cards asked, {len(jax.devices())} found")
    import bench

    print(f"card: {bench.gpu_info()}", flush=True)
    return {"platform": dev.platform, "kind": dev.device_kind, "count": n_cards}


def phase_filter(params, agents=(128, 512), n_steps=20) -> None:
    import bench

    for a in agents:
        ups = bench.bench_matches(params, a, n_steps)
        print(f"filter {a} agents: {ups:.1f} updates/s", flush=True)
    lat = bench.bench_batch1_latency(params, n_steps=n_steps)
    print(f"filter batch-1: {lat:.3f} ms/update", flush=True)


def innovation_batch(batch: int, n: int, kappa_lo: float, kappa_hi: float,
                     seed: int = 0):
    """SPD innovation matrices S = H P H^T + I with condition numbers
    log-spaced over [kappa_lo, kappa_hi], and the Kalman right-hand sides
    B = H P that the filter solves them against (float64, numpy)."""
    rng = np.random.default_rng(seed)
    kappa = np.logspace(np.log10(kappa_lo), np.log10(kappa_hi), batch)
    s = np.empty((batch, n, n))
    b = np.empty((batch, n, n - 1))
    for i in range(batch):
        h = rng.normal(size=(n, n - 1)) / np.sqrt(n - 1)
        q, _ = np.linalg.qr(rng.normal(size=(n - 1, n - 1)))
        p = (q * np.logspace(-3, 0, n - 1)) @ q.T
        p = p * (kappa[i] - 1.0) / np.linalg.eigvalsh(h @ p @ h.T)[-1]
        s[i] = h @ p @ h.T + np.eye(n)
        s[i] = 0.5 * (s[i] + s[i].T)
        b[i] = h @ p
    return s, b, kappa


def solve_residuals(s, b):
    """Relative residuals ||S x - b|| / ||b|| of ``spd_solve`` and of the
    Cholesky oracle, both in float32 as the filter calls them (under
    ``highprec``), measured in float64."""
    import jax
    import jax.numpy as jnp

    from x_multi_agent_jax.ops import linalg

    s32 = jnp.asarray(s, jnp.float32)
    b32 = jnp.asarray(b, jnp.float32)
    s64 = np.asarray(s32, np.float64)
    b64 = np.asarray(b32, np.float64)

    def rel(x):
        x = np.asarray(x, np.float64)
        return (np.linalg.norm(s64 @ x - b64, axis=(1, 2))
                / np.linalg.norm(b64, axis=(1, 2)))

    solve = jax.jit(jax.vmap(linalg.highprec(linalg.spd_solve)))
    oracle = jax.jit(jax.vmap(linalg.highprec(linalg.spd_solve_chol)))
    return rel(solve(s32, b32)), rel(oracle(s32, b32))


def phase_solve(batch=128, n=151) -> None:
    s, b, kappa = innovation_batch(batch, n, 1e2, 1e6)
    res, res_oracle = solve_residuals(s, b)
    ratio = res / res_oracle
    well = kappa <= 1e4
    print(f"solve: max residual {res.max():.3e} (oracle {res_oracle.max():.3e}), "
          f"max ratio to oracle {ratio.max():.2f}, "
          f"max residual at kappa<=1e4 {res[well].max():.3e}", flush=True)
    check(np.isfinite(res).all(), "spd_solve residual not finite")
    check((ratio <= 10.0).all(),
          f"spd_solve residual > 10x the oracle's (max ratio {ratio.max():.2f})")
    check((res[well] <= 1e-5).all(),
          f"spd_solve residual {res[well].max():.3e} > 1e-5 at kappa <= 1e4")


def phase_image(params, n_agents=16, n_steps=20) -> None:
    import bench

    fps = bench.bench_image(params, n_agents, n_steps)
    print(f"image {n_agents} agents: {fps:.1f} frames/s", flush=True)


def lk_inputs(n_agents: int, budget: int = 200):
    """Pyramids of two consecutive 480x640 orbit frames per agent and the
    ``budget`` best FAST corners of the first (off the pixel grid)."""
    import jax
    import jax.numpy as jnp

    import bench
    from x_multi_agent_jax.vision import fast
    from x_multi_agent_jax.vision.image import build_pyramid

    h, w = bench.IMG_H, bench.IMG_W
    tparams, _ = bench.image_tracker(budget)
    frames, _, _ = bench._orbit_frames(n_agents, 2, h, w, 0.8 * w)
    pyr = jax.jit(jax.vmap(lambda im: build_pyramid(im, tparams.lk_max_level)))
    xy, score, valid = jax.jit(
        lambda im: fast.detect_batch(
            im, tparams.fast_threshold, tparams.n_tiles_h, tparams.n_tiles_w,
            tparams.max_feat_per_tile,
        )
    )(frames[0])
    order = jnp.argsort(-jnp.where(valid, score, -1.0), axis=1)[:, :budget]
    pts = jnp.take_along_axis(xy, order[..., None], axis=1) + 0.37
    valid = jnp.take_along_axis(valid, order, axis=1)
    return pyr(frames[0]), pyr(frames[1]), pts, valid, tparams


def compare_lk(pyr_prev, pyr_cur, pts, valid, tparams):
    """(max |d flow| where both sides are ok, share of agreeing ok flags,
    number of features both mark ok) of the kernel vs the plain levels."""
    import jax

    from x_multi_agent_jax.vision import lk, lk_triton

    kw = dict(half_win=tparams.win_half, n_iters=tparams.lk_iters,
              min_eig_thr=tparams.min_eig_thr)
    ref = jax.jit(jax.vmap(
        lambda pp, pc, p, v: lk.track(pp, pc, p, v, **kw)
    ))
    got = jax.jit(lambda pp, pc, p, v: lk_triton.track_batch(pp, pc, p, v, **kw))
    pts_r, ok_r = ref(list(pyr_prev), list(pyr_cur), pts, valid)
    pts_g, ok_g = got(list(pyr_prev), list(pyr_cur), pts, valid)
    ok_r, ok_g = np.asarray(ok_r), np.asarray(ok_g)
    both = ok_r & ok_g
    dflow = np.abs(np.asarray(pts_g) - np.asarray(pts_r))[both]
    return (float(dflow.max()) if both.any() else 0.0,
            float((ok_r == ok_g).mean()), int(both.sum()))


def phase_lk(n_agents=16) -> None:
    pyr_prev, pyr_cur, pts, valid, tparams = lk_inputs(n_agents)
    dflow, agree, n_ok = compare_lk(pyr_prev, pyr_cur, pts, valid, tparams)
    print(f"lk kernel: max |dflow| {dflow:.2e} px over {n_ok} features, "
          f"ok agreement {agree:.4f}", flush=True)
    check(n_ok >= n_agents * 50, f"only {n_ok} features tracked")
    check(dflow <= 1e-3, f"kernel flow differs by {dflow:.2e} px")
    check(agree >= 0.995, f"ok masks agree on only {agree:.4f}")


def phase_facade(params, n_frames=40) -> None:
    import jax.numpy as jnp

    import bench
    from x_multi_agent_jax.utils import scene
    from x_multi_agent_jax.vio import vio as vio_mod

    h, w = bench.IMG_H, bench.IMG_W
    cam_rate, imu_rate = 20.0, 200.0
    traj = scene.orbit_traj(
        duration=(n_frames + 1) / cam_rate, imu_rate=imu_rate,
        cam_rate=cam_rate, radius=1.5, omega=0.6, yaw_amp=0.15,
        pitch_amp=0.10, roll_amp=0.08, z_amp=0.3, seed=0,
    )
    tex = jnp.asarray(scene.make_texture(0, size=2048).astype(np.float32))

    def render(p, rot):
        return scene.render_wall_frames_jax(
            tex, jnp.asarray(p[None], jnp.float32),
            jnp.asarray(rot[None], jnp.float32), h, w, 0.8 * w, 0.8 * w,
        )[0]

    tparams, cam = bench.image_tracker(params.cfg.tracks.n_matches)
    v = vio_mod.VIO(params)
    v.init_at_time(0.0, p=traj["p0"], v=traj["v0"], q=traj["q0"])
    v.setup_tracker(tparams, cam, h, w)
    v.process_image_measurement(0.0, 0, render(traj["p0"], scene.quat_to_rot(traj["q0"])))

    per_frame = int(imu_rate / cam_rate)
    errs = []
    for f in range(n_frames):
        for i in range(f * per_frame + 1, (f + 1) * per_frame + 1):
            v.process_imu(traj["imu_t"][i], i, traj["imu_w"][i], traj["imu_a"][i])
        img = render(traj["cam_p"][f], traj["cam_rot"][f])
        v.process_image_measurement(traj["cam_t"][f], f + 1, img)
        p = np.asarray(v.tail_state().p)
        check(np.isfinite(p).all(), f"facade position NaN at frame {f}")
        errs.append(float(np.linalg.norm(p - traj["cam_p"][f])))
    check(np.isfinite(np.asarray(v.fs.cov)).all(), "facade covariance not finite")
    print(f"facade: {n_frames} frames, final err {errs[-1]:.4f} m, "
          f"max err {max(errs):.4f} m", flush=True)
    check(max(errs) < 1.0, f"facade lost the trajectory (max err {max(errs):.2f} m)")


def fleet_on(params, n_agents, mesh=None):
    """Drive the distinct-trajectory fleet for 20 frames, then one full-map
    exchange round and one descriptor request-response round — on one device when
    ``mesh`` is None, else sharded over the mesh's ``agents`` axis."""
    import jax

    import __graft_entry__ as ge
    from x_multi_agent_jax.ekf import ekf as ekf_mod
    from x_multi_agent_jax.parallel import collab
    from x_multi_agent_jax.parallel import mesh as pmesh

    drive = ge.fleet_drive(params, n_agents, duration=2.0)
    ccfg, dccfg = ge.collab_configs()
    fs, slots = drive["fs"], drive["slots"]
    if mesh is None:
        step = jax.jit(pmesh.agent_step_fn(params))
        full_round = lambda fs: collab.collaborative_round_jit(params, ccfg, fs)
    else:
        step = pmesh.sharded_step(params, mesh)
        full_round = pmesh.sharded_collab_round(params, ccfg, mesh)
    applied = []
    for inputs in drive["frames"]:
        fs, slots, app = step(fs, slots, *inputs)
        applied.append(np.asarray(app))
    fs, n_full = full_round(fs)
    words, db, _ = ge.keyframe_dbs(params, fs, slots, drive["desc_table"])
    if mesh is None:
        desc_round = jax.jit(
            lambda f, s, d: collab.request_response_round(params, dccfg, words, f, s, d)
        )
    else:
        desc_round = pmesh.sharded_collab_round_desc(params, dccfg, words, mesh)
    fs, db, hits, n_desc = desc_round(fs, slots, db)
    return dict(
        applied=np.stack(applied), n_full=np.asarray(n_full),
        hits=np.asarray(hits), n_desc=np.asarray(n_desc),
        p=np.asarray(jax.vmap(ekf_mod.tail_core)(fs).p, np.float64),
        cov=np.asarray(fs.cov, np.float64),
    )


def compare_fleets(one, sharded) -> None:
    """Counts must be equal; positions within 1e-4 m, covariances within
    1e-4 of each agent's largest entry."""
    for key in ("applied", "n_full", "hits", "n_desc"):
        check(np.array_equal(one[key], sharded[key]),
              f"mesh {key} differs from one card")
    check(one["n_full"].sum() > 0 and one["n_desc"].sum() > 0,
          "exchange rounds fused nothing: the comparison is vacuous")
    dp = float(np.abs(one["p"] - sharded["p"]).max())
    scale = np.abs(one["cov"]).max(axis=(1, 2), keepdims=True)
    dcov = float((np.abs(one["cov"] - sharded["cov"]) / scale).max())
    print(f"mesh vs one card: applied {int(one['applied'].sum())}, "
          f"full-map matches {int(one['n_full'].sum())}, "
          f"desc hits {int(one['hits'].sum())}, desc matches "
          f"{int(one['n_desc'].sum())}; max |dp| {dp:.2e} m, "
          f"max cov rel diff {dcov:.2e}", flush=True)
    check(dp <= 1e-4, f"mesh positions differ by {dp:.2e} m")
    check(dcov <= 1e-4, f"mesh covariances differ by {dcov:.2e} (relative)")


def phase_mesh(params, n_cards, n_agents=16) -> None:
    import jax

    from x_multi_agent_jax.parallel import mesh as pmesh

    one = fleet_on(params, n_agents)
    mesh = pmesh.make_agent_mesh(jax.devices()[:n_cards])
    sharded = fleet_on(params, n_agents, mesh)
    compare_fleets(one, sharded)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4 runs only the agents mesh over four cards")
    args = ap.parse_args()

    device = phase_device(args.cards)

    import __graft_entry__ as ge
    from x_multi_agent_jax.utils import compile_cache

    compile_cache.enable()
    params = ge._params(small=False)
    if args.cards == 1:
        phases = [
            ("filter", lambda: phase_filter(params)),
            ("solve", phase_solve),
            ("image", lambda: phase_image(params)),
            ("lk", phase_lk),
            ("facade", lambda: phase_facade(params)),
        ]
    else:
        phases = [("mesh", lambda: phase_mesh(params, args.cards))]
    for name, run in phases:
        t0 = time.perf_counter()
        print(f"== {name}", flush=True)
        run()
        print(f"== {name} ok ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
