"""Show that chip_smoke.py's integrate and solve checks reject planted
faults at full size.

Integrate: the bench clip (30 frames at 640x480) on the device, compared
with the honest CPU reference by chip_smoke.layer_agreement /
check_layer_agreement, for the honest device run and three faults:
depth read one pixel to the side, camera poses rounded to bf16, and one
frame's update lost. Solve: chip_smoke's solve checks for the honest
device solve and for one whose pose-graph normal equations are built at
the default matmul precision (TF32 on a GPU's tensor cores).

With ``--device cpu`` (no GPU needed; use a small ``--scale``) the honest
run is replaced by one with camera positions nudged by a relative 1e-7,
a stand-in for last-bit differences between backends; the CPU computes
default-precision contractions in full f32, so there the TF32 control
passes.

Usage:
    python tools/smoke_faults.py [--device gpu|cpu] [--scale 1.0]
        [--frames 30] [--no-integrate] [--no-solve]
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the CPU reference runs in this process beside the device
if os.environ.get("JAX_PLATFORMS") and \
        "cpu" not in os.environ["JAX_PLATFORMS"].split(","):
    os.environ["JAX_PLATFORMS"] += ",cpu"

import numpy as np  # noqa: E402


def integrate_faults(dev, cpu, scale: float, frames: int) -> None:
    import jax.numpy as jnp

    import chip_smoke as cs
    from coxgraph_tpu.eval import benchmarks as bm

    cfg = bm._mapper_config(scale)
    depths, colors, traj = bm.render_frames(frames, scale)
    ref = cs._integrate_on(cpu, cfg, depths, colors, traj)
    weights = cs.clip_observation_weights(cfg, traj)
    keep = np.arange(frames) != frames // 2
    if dev.platform == "cpu":
        nudged = traj.copy()
        rng = np.random.default_rng(0)
        nudged[:, 4:7] *= (1 + rng.normal(0, 1e-7, nudged[:, 4:7].shape)
                           ).astype(np.float32)
        honest = ("poses nudged by 1e-7 relative", depths, colors, nudged)
    else:
        honest = ("honest", depths, colors, traj)
    runs = [honest,
            ("depth one pixel to the side", np.roll(depths, 1, axis=-1),
             colors, traj),
            ("poses rounded to bf16", depths, colors, np.asarray(
                jnp.asarray(traj).astype(jnp.bfloat16).astype(jnp.float32))),
            (f"frame {frames // 2} lost", depths[keep], colors[keep],
             traj[keep])]
    for name, d, c, t in runs:
        rep = cs.Report()
        rep.phase = name
        print(f"[integrate: {name}]", flush=True)
        got = cs._integrate_on(dev, cfg, d, c, t)
        agree = cs.layer_agreement(cfg.spec, got, ref, weights)
        cs.check_layer_agreement(rep, f"{dev.platform} vs cpu", agree)
        for q in (0.9, 0.999, 0.9999, 0.99999):
            print(f"  q{100 * q:g} |dsdf| m "
                  f"{np.quantile(agree['dsdf_m'], q)}, |dw| observations "
                  f"{np.quantile(agree['dw_obs'], q)}", flush=True)
        print(f"  verdict: {'FAILS' if rep.failed else 'passes'} the "
              "integrate check", flush=True)


def solve_faults(dev, cpu) -> None:
    import jax

    import chip_smoke as cs
    from coxgraph_tpu.solver import pose_graph as pg

    ctx = cs.Ctx(dev, cpu, cs.Sizes())
    for name, precision in (("honest", pg._HI),
                            ("normal equations at default precision",
                             jax.lax.Precision.DEFAULT)):
        pg._HI = precision
        jax.clear_caches()
        rep = cs.Report()
        rep.phase = name
        print(f"[solve: {name}]", flush=True)
        cs.phase_solve(rep, ctx)
        print(f"  verdict: {'FAILS' if rep.failed else 'passes'} the "
              "solve check", flush=True)
    pg._HI = jax.lax.Precision.HIGHEST


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--no-integrate", action="store_true")
    ap.add_argument("--no-solve", action="store_true")
    args = ap.parse_args()

    import jax

    from coxgraph_tpu.utils import runtime

    runtime.enable_compilation_cache()
    cpu = jax.devices("cpu")[0]
    if args.device == "gpu":
        dev = runtime.require_gpu()
        print(f"card: {runtime.gpu_card_line()}", flush=True)
    else:
        dev = cpu
    if not args.no_integrate:
        integrate_faults(dev, cpu, args.scale, args.frames)
    if not args.no_solve:
        solve_faults(dev, cpu)


if __name__ == "__main__":
    main()
