"""Time and op-profile the frame-integration window on the GPU.

Runs the bench configuration (eval/benchmarks: 640x480, 5 cm voxels,
16³ blocks) through one warm ``integrate_batch`` window, times it with
the profiler off (best of ``--repeats``, each fenced on a readback of the
integrated weights), then traces one more window with jax.profiler and
reduces the trace with ``jax.profiler.ProfileData``: device busy time,
the idle share of the traced window, and the top device ops by summed
duration. Prints the card's name and power limit beside the numbers.

Usage:
    python tools/profile_integrate.py [--frames 30] [--scale 1.0]
        [--top 25] [--tracedir runs/trace_integrate]
"""

import argparse
import collections
import glob
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def device_events(xplane_path: str):
    """→ {device plane name: [(op name, start_ns, duration_ns)]} from the
    per-op line of every GPU plane in a profiler trace."""
    from jax.profiler import ProfileData

    out = {}
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = {line.name: line for line in plane.lines}
        ops = lines.get("XLA Ops")
        chosen = [ops] if ops is not None else [
            ln for n, ln in lines.items()
            if n not in ("XLA Modules", "Steps", "XLA TraceMe")]
        out[plane.name] = [(e.name, e.start_ns, e.duration_ns)
                           for ln in chosen for e in ln.events]
    return out


def busy_ns(events) -> float:
    """Union length of the events' [start, start + duration) intervals."""
    total, end = 0.0, float("-inf")
    for _, s, d in sorted(events, key=lambda e: e[1]):
        if s > end:
            total += d
            end = s + d
        elif s + d > end:
            total += s + d - end
            end = s + d
    return total


def report(xplane_path: str, top: int) -> None:
    """Per GPU plane: busy time, idle share between the first op's start
    and the last op's end, and the top ops by summed duration."""
    for plane, events in device_events(xplane_path).items():
        if not events:
            print(f"{plane}: no op events")
            continue
        by_name = collections.Counter()
        for name, _, d in events:
            by_name[name] += d
        summed = sum(by_name.values())
        busy = busy_ns(events)
        span = (max(s + d for _, s, d in events)
                - min(s for _, s, _ in events))
        print(f"{plane}: {len(events)} op events, busy {busy / 1e6:.3f} ms "
              f"of a {span / 1e6:.3f} ms first-to-last-op span (idle share "
              f"{1 - busy / span:.3f})")
        for name, d in by_name.most_common(top):
            print(f"  {d / 1e6:9.4f} ms {100 * d / max(summed, 1):5.1f}%  "
                  f"{name}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--tracedir",
                    default=os.path.join(ROOT, "runs",
                                         "trace_integrate"))
    args = ap.parse_args()

    from coxgraph_tpu.utils import runtime

    runtime.enable_compilation_cache()
    dev = runtime.require_gpu()
    print(f"card: {runtime.gpu_card_line()} ({dev.device_kind})")

    import jax
    import jax.numpy as jnp

    from coxgraph_tpu.eval import benchmarks as bm
    from coxgraph_tpu.mapper import submap_mapper as sm

    cfg = bm._mapper_config(args.scale)
    d, c, traj = bm.render_frames(args.frames, args.scale)
    d, c, traj = (jnp.asarray(x) for x in (d, c.astype("float32"), traj))
    ts = jnp.arange(args.frames, dtype=jnp.float32) * 0.05

    def fresh():
        s = sm.create_mapper(cfg)
        s = sm.start_submap(cfg, s, traj[0], jnp.asarray(0.0))
        float(jnp.sum(s.collection.layers.weight))
        return s

    def window(s):
        s = sm.integrate_batch(cfg, s, d, c, traj, ts)
        float(jnp.sum(s.collection.layers.weight))     # readback fence
        return s

    window(fresh())                                     # compile + warm
    best = float("inf")
    for _ in range(args.repeats):
        s = fresh()
        t0 = time.perf_counter()
        window(s)
        best = min(best, time.perf_counter() - t0)
    print(f"integrate_batch window: {args.frames} frames at "
          f"{cfg.intrinsics.width}x{cfg.intrinsics.height}, best of "
          f"{args.repeats} {best * 1e3:.3f} ms "
          f"({args.frames / best:.1f} frames/s)")

    s = fresh()
    with jax.profiler.trace(args.tracedir):
        window(s)
    runs = sorted(glob.glob(os.path.join(args.tracedir, "plugins",
                                         "profile", "*")))
    report(glob.glob(os.path.join(runs[-1], "*.xplane.pb"))[0], args.top)


if __name__ == "__main__":
    main()
