"""Benchmark: TSDF integration frames/s on one GPU (headline) + the
two-phase registration solve (the "ICP" half of BASELINE.md's TSDF+ICP
target).

Prints the card's name and power limit (nvidia-smi) on one line, then ONE
JSON line:
  {"metric": "tsdf_integration_fps", "value": N, "unit": "frames/s/gpu",
   "device": {...}, "extra_metrics": {...}}

Runs in one process and exits non-zero when JAX finds no GPU: a CPU run
is never reported as a device number. The operating point is
BASELINE.md's: 640x480 @ 5 cm voxels, 0.15 m truncation, 10 m max range.
The bench clip is rendered once and cached in .bench_frames.npz.

Run: python bench.py [--frames N] [--no-solve]
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
FRAMES = os.path.join(REPO, ".bench_frames.npz")
N_FRAMES = 30


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--no-solve", action="store_true",
                    help="skip the two_phase_optimize_s extra metric")
    args = ap.parse_args()

    from coxgraph_tpu.utils import runtime
    runtime.enable_compilation_cache()
    dev = runtime.require_gpu()

    import jax

    from coxgraph_tpu.eval import benchmarks as bm

    if not os.path.exists(FRAMES):
        bm.generate_frames(FRAMES, N_FRAMES)
    depths, colors, traj = bm.load_frames(FRAMES)
    n = args.frames
    fps = bm.tsdf_benchmark(depths, colors, traj, n_frames=n)
    extra = bm.stage_benchmark(depths[:n], colors[:n], traj[:n])
    if not args.no_solve:
        solve = bm.solve_benchmark()
        extra.update({
            "two_phase_optimize_s": round(solve["solve_s"], 3),
            "two_phase_optimize_best_s": round(solve["solve_best_s"], 3),
            "solve_submaps": solve["submaps"],
            "solve_pairs": solve["pairs"],
        })

    result = {
        "metric": "tsdf_integration_fps",
        "value": round(fps, 2),
        "unit": "frames/s/gpu",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extra_metrics": extra,
    }
    print(f"# card: {runtime.gpu_card_line()}")
    sys.stdout.flush()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
