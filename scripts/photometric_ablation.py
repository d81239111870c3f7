"""Does the per-cell spatial photometric path earn its keep? (VERDICT r4
weak item 7.)

Renders a SPATIALLY-DOMINANT thermal variant of the agent-0 trajectory
(strong corner vignette, no gain drift, low noise — the regime the
spatial machinery exists for, irPhotoCalib.cpp:314-406) and replays it
solo under three photometric modes:

    off      no online correction
    global   global-gain correction only (the flagship default)
    spatial  global + per-cell spatial map + GPR

Prints one JSON line per mode (ATE, NEES, re-inits) and a verdict line.
"""
import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import ate_report as ar  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=250)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--vignette", type=float, default=0.30)
    ap.add_argument("--noise", type=float, default=0.004)
    ap.add_argument("--sigma-img-px", type=float, default=14.0)
    ap.add_argument("--modes", type=str, default="off,global,spatial")
    args = ap.parse_args()

    from x_multi_agent_jax.utils import compile_cache

    compile_cache.enable()

    from x_multi_agent_jax.utils import scene

    thermal = dict(
        drift_a=0.0, drift_b=0.0, noise=args.noise, vignette=args.vignette
    )
    adir = os.path.join(
        ar.DATASET_ROOT, f"agent0_vign{int(args.vignette * 100)}"
    )
    meta_p = os.path.join(adir, "meta.json")
    gen_key = dict(thermal=thermal, duration=args.duration)
    regen = True
    if os.path.exists(meta_p):
        with open(meta_p) as f:
            meta = json.load(f)
        regen = meta.get("gen_key") != gen_key
    if regen:
        print(f"generating vignette={args.vignette} dataset...", flush=True)
        tex = scene.make_texture(0)
        info = scene.generate_agent_dataset_6dof(
            adir, seed=100, duration=args.duration, h=480, w=640,
            phase=0.0, tex=tex, wall2_x=4.0, thermal=thermal,
            z_amp=ar.MOTION["z_amp"], yaw_amp=ar.MOTION["yaw_amp"],
            pitch_amp=ar.MOTION["pitch_amp"], roll_amp=ar.MOTION["roll_amp"],
        )
        meta = dict(
            duration=args.duration, h=480, w=640, fx=info["fx"],
            fy=info["fy"], v0=list(map(float, info["v0"])),
            p0=list(map(float, info["p0"])),
            q0=list(map(float, info["q0"])),
            gen_key=gen_key,
        )
        with open(meta_p, "w") as f:
            json.dump(meta, f)
    with open(meta_p) as f:
        meta = json.load(f)
    gt = np.loadtxt(os.path.join(adir, "gt.csv"), delimiter=",", comments="#")
    meta = dict(meta, cam_t=gt[:, 0], cam_p=gt[:, 1:4], dir=adir)

    photometric = dict(
        off=None,
        **{"global": dict(n_obs=80, spatial=False, cell_px=80,
                          spatial_every=20)},
        spatial=dict(n_obs=80, spatial=True, cell_px=80, spatial_every=20),
    )
    results = {}
    for mode in args.modes.split(","):
        overrides = dict(
            sigma_img_px=args.sigma_img_px,
            photometric=photometric[mode],
        )
        v = ar.build_agent(
            meta, False, None, None, 0, collab=False, overrides=overrides
        )
        r = ar.replay([v], [meta], exchange=False, max_frames=args.frames)
        results[mode] = dict(
            ate_aligned=round(r["ate_aligned"][0], 4),
            ate=round(r["ate"][0], 4),
            mean_nees=round(r["mean_nees"][0], 2),
            n_reinits=r["n_reinits"][0],
        )
        print(json.dumps({mode: results[mode]}), flush=True)

    if "global" in results and "spatial" in results:
        g, s = results["global"], results["spatial"]
        improves = s["ate_aligned"] < 0.9 * g["ate_aligned"]
        print(json.dumps(dict(
            vignette=args.vignette,
            spatial_improves_ate=bool(improves),
            ate_global=g["ate_aligned"], ate_spatial=s["ate_aligned"],
        )))


if __name__ == "__main__":
    main()
