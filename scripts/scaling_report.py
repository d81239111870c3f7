"""Scaling sweep: EKF update throughput + image-pipeline frame rate vs
agent count on one GPU (BASELINE.md scaling axis), plus batch=1 latency.

Writes SCALING.md at the repo root. Multi-process meshes are exercised
separately by scripts/multihost_demo.py (jax.distributed multi-process CPU
run), the virtual-mesh dryrun (__graft_entry__.dryrun_multichip) and
``chip_smoke.py --cards 4``.
"""
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
from x_multi_agent_jax.utils import compile_cache  # noqa: E402


def main():
    import __graft_entry__ as ge

    compile_cache.enable()
    bench.device_record()
    card = bench.gpu_info()
    params = ge._params(small=False)

    agents = [int(a) for a in os.environ.get(
        "SCALE_AGENTS", "1,8,32,64,128,256,512").split(",")]
    img_agents = [int(a) for a in os.environ.get(
        "SCALE_IMG_AGENTS", "1,4,8,16,32").split(",")]

    rows = []
    for a in agents:
        ups = bench.bench_matches(params, a, 20)
        rows.append((a, ups))
        print(f"matches agents={a}: {ups:.1f} updates/s", flush=True)

    img_rows = []
    for a in img_agents:
        fps = bench.bench_image(params, a, 8)
        img_rows.append((a, fps))
        print(f"image agents={a}: {fps:.1f} frames/s", flush=True)

    lat = bench.bench_batch1_latency(params)
    print(f"batch=1 update latency: {lat:.3f} ms", flush=True)

    with open(os.path.join(REPO, "SCALING.md"), "w") as f:
        f.write(f"# Scaling report (one GPU: {card})\n\n")
        f.write("Match-driven filter step (10 IMU samples + fused visual "
                "update incl. track churn), M=N=15, f32:\n\n")
        f.write("| agents | updates/s/chip | updates/s/agent |\n|---|---|---|\n")
        for a, v in rows:
            f.write(f"| {a} | {v:.1f} | {v / a:.1f} |\n")
        f.write("\nFull image pipeline (480x640 render -> pyramid + 2-level "
                "FAST + pyramidal LK + RANSAC + fused update):\n\n")
        f.write("| agents | frames/s/chip | frames/s/agent |\n|---|---|---|\n")
        for a, v in img_rows:
            f.write(f"| {a} | {v:.1f} | {v / a:.1f} |\n")
        f.write(f"\nSingle-agent (batch=1) update latency: **{lat:.2f} ms** "
                "(reference real-time target: camera rate, 33-50 ms).\n")
        f.write("\nMulti-chip execution: agents-sharded shard_map path "
                "(`__graft_entry__.dryrun_multichip`, virtual 8-device mesh, "
                "exchange round fusing real matches); four GPUs: "
                "`chip_smoke.py --cards 4`; multi-process path: "
                "`scripts/multihost_demo.py` (2-process jax.distributed).\n")
    print("wrote SCALING.md")


if __name__ == "__main__":
    main()
