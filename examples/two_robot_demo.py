"""Two-robot collaborative reconstruction demo — the CVG 2-client
experiment equivalent (BASELINE.json config 4): two robots with separate
drifting odometry frames map overlapping halves of a scene; the loop
detector finds cross-robot correspondences automatically; the fusion
server aligns the client frames, runs the two-phase global solve, and
exports one globally consistent mesh + per-client trajectories
(coxgraph_tpu/eval/mission.py).

Run: python examples/two_robot_demo.py [--frames N] [--scale S] [--cpu]
                                       [--out DIR]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None,
                    help="directory for the PLY mesh and TUM trajectories")
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--reg-weight", type=float, default=30.0)
    ap.add_argument("--skip-mesh", action="store_true")
    args = ap.parse_args()

    from coxgraph_tpu.utils import runtime
    if args.cpu:
        runtime.force_cpu()
    runtime.enable_compilation_cache()

    import jax

    from coxgraph_tpu.eval.mission import two_robot_mission

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    print(f"backend: {jax.default_backend()}")
    m = two_robot_mission(args.frames, args.scale, args.reg_weight,
                          args.out, with_mesh=not args.skip_mesh)
    print(f"streamed {2 * args.frames} frames in {m['stream_wall_s']:.1f}s, "
          f"{m['fusions']} map fusions accepted, "
          f"{m['server_submaps']} server submaps")
    print(f"async PGO: {m['solve_wall_s']:.1f}s of solve, "
          f"{m['fusion_dispatch_s']:.1f}s charged to the stream loop")
    print(f"client-1 frame alignment error: rot {m['client1_align_rot']:.4f} "
          f"trans {m['client1_align_trans']:.4f}")
    for r, ate in enumerate(m["ate_m"]):
        print(f"client {r}: global-frame ATE {ate * 100:.2f} cm")
    ok = (m["fusions"] > 0 and not m["optimize_errors"]
          and max(m["ate_m"]) < 0.13)
    if not args.skip_mesh:
        print(f"global mesh: {m['mesh_tris']} tris, surface err "
              f"p50 {m['surface_err_p50_m'] * 100:.1f} cm "
              f"p90 {m['surface_err_p90_m'] * 100:.1f} cm")
        # 4 voxels (5 cm each)
        ok = ok and m["mesh_tris"] > 1000 and m["surface_err_p90_m"] < 0.2
    print("DEMO", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
