"""Smoke test of the collaborative mapping path on one NVIDIA GPU.

Drives the system once through its normal entry points at the reference
operating point (640×480 RGB-D, 5 cm voxels, 16³ blocks, 0.15 m
truncation, 10 m max range — BASELINE.md) and compares every device
result with the plain reference: the same code on the CPU backend of this
process (``jax.devices("cpu")[0]``), a NumPy popcount, or ground truth.

Phases: device, integrate, serve, solve, detect, mission. Each prints its
wall and compile time, the device's ``peak_bytes_in_use``, and every
compared quantity beside its tolerance. The last stdout line is
``{"ok": true, "device": {...}}`` only when every phase passed; any
failure, or no GPU, exits non-zero without it.

``--four-gpus`` runs only the fleet path over four GPUs (one robot per
card, the distributed pose-graph solve, the block-sharded ESDF and the
sharded merge) and the single-device computations it is compared with.

Run: python chip_smoke.py [--four-gpus]
"""

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

# the CPU reference runs in this process beside the GPU
if os.environ.get("JAX_PLATFORMS") and \
        "cpu" not in os.environ["JAX_PLATFORMS"].split(","):
    os.environ["JAX_PLATFORMS"] += ",cpu"

import numpy as np  # noqa: E402

COMPILE_EVENTS = ("/jax/core/compile/backend_compile_duration",
                  "/jax/core/compile/jaxpr_trace_duration",
                  "/jax/core/compile/jaxpr_to_mlir_module_duration")


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes. The defaults are the reference operating point with
    only the mission's length cut; tests run the phases at TINY."""

    scale: float = 1.0               # of the 640×480 sensor
    integrate_frames: int = 30       # the bench clip
    mission_frames: int = 40         # per robot; submap interval n·dt/6
    detect_keyframes: int = 2048     # LoopDetectorConfig.max_keyframes
    detect_keypoints: int = 512      # FeatureConfig.max_keypoints
    detect_numpy_keyframes: int = 64  # DB rows also checked in NumPy
    solve_submaps: int = 64          # eval/benchmarks.SOLVE_N
    fleet_frames: int = 6            # per robot, 2 per submap
    merge_max_blocks: int = 8192


TINY = Sizes(scale=0.125, integrate_frames=3, mission_frames=12,
             detect_keyframes=8, detect_keypoints=64,
             detect_numpy_keyframes=8, solve_submaps=6, fleet_frames=6,
             merge_max_blocks=2048)


class Report:
    """Per-phase timing, memory and check bookkeeping, printed as it
    goes."""

    def __init__(self, mem_device=None):
        self.mem_device = mem_device
        self.failed = []           # "phase: check" / "phase: exception"
        self.compile_s = 0.0
        self.phase = None
        import jax.monitoring

        def on_event(event, duration, **_):
            if event in COMPILE_EVENTS:
                self.compile_s += duration
        jax.monitoring.register_event_duration_secs_listener(on_event)

    def check(self, name: str, value, tol, ok: bool) -> bool:
        print(f"  {name}: {value} (tolerance {tol}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failed.append(f"{self.phase}: {name}")
        return ok

    def info(self, name: str, value) -> None:
        print(f"  {name}: {value}", flush=True)

    def run(self, name: str, fn, *args) -> None:
        self.phase = name
        print(f"[{name}]", flush=True)
        c0, t0 = self.compile_s, time.perf_counter()
        try:
            fn(self, *args)
        except Exception:                    # noqa: BLE001 — report, go on
            traceback.print_exc()
            self.failed.append(f"{name}: exception")
        wall = time.perf_counter() - t0
        peak = None
        if self.mem_device is not None:
            stats = self.mem_device.memory_stats() or {}
            peak = stats.get("peak_bytes_in_use")
        print(f"[{name}] wall {wall:.3f} s, compile {self.compile_s - c0:.3f}"
              f" s, peak_bytes_in_use {peak}", flush=True)


# ---------------------------------------------------------------------------
# comparison helpers (host arrays)
# ---------------------------------------------------------------------------


# Voxel tolerances of layer_agreement. The integrator weighs one
# observation 1/max(d², 1) at depth d (ops/tsdf), times a dropoff that
# ramps linearly to 0 from -τ/2 to -τ behind the surface: slope
# 1/(0.5·τ) = 13.3 observations per metre of sdf at the bench's τ =
# 0.15 m. Weights are therefore compared in units of one observation at
# the voxel's depth (observation_weights): an sdf difference of SDF_TOL_M
# moves the weight by at most 1.3e-3 of one observation, so WEIGHT_TOL_OBS
# matches it. (A relative tolerance cannot work: near the end of the ramp
# a last-bit depth difference is an unbounded relative weight difference.)
# A voxel whose centre projects onto a pixel-rounding boundary can read
# the neighbouring pixel on another backend; on the ramp that moves its
# weight by ~1e-2 of an observation. At the bench clip such voxels are
# 0.13 % of those observed (H100 against the CPU), so the bulk gate
# allows 0.2 %, and the tail is bounded at its 99.99 % quantile: there
# the H100 reads 2.9e-3 m and 0.17 observations, while a planted fault at
# full size (depth one pixel aside, bf16 poses, one frame lost) puts
# ≥ 28 % of voxels outside the bulk gate and reads ≥ 2.5e-2 m and ≥ 1.5
# observations (tools/smoke_faults.py; PERF.md).
SDF_TOL_M = 1e-4
WEIGHT_TOL_OBS = 1e-3
MIN_SHARE = 0.998
TAIL_Q = 0.9999
TAIL_SDF_TOL_M = 1e-2
TAIL_WEIGHT_TOL_OBS = 0.5


def observation_weights(intr, T_layer_cams, centers,
                        min_range: float = 0.1) -> np.ndarray:
    """Weight of one full observation (1/max(z², 1)) of each point of
    ``centers`` (N,3), in the layer's frame: the mean over the cameras
    ``T_layer_cams`` (F,7), also in the layer's frame, that see it; the
    lightest observation any camera makes of it where none does."""
    from coxgraph_tpu.core import geometry as geo

    centers = np.asarray(centers, np.float64)
    total = np.zeros(len(centers))
    count = np.zeros(len(centers))
    lightest = np.full(len(centers), np.inf)
    for T in np.asarray(T_layer_cams, np.float64):
        p = geo.transform_points_np(geo.inverse_np(T), centers)
        z = p[:, 2]
        zs = np.maximum(z, 1e-6)
        u = np.round(p[:, 0] / zs * intr.fx + intr.cx)
        v = np.round(p[:, 1] / zs * intr.fy + intr.cy)
        w = 1.0 / np.maximum(z * z, 1.0)
        seen = ((z > min_range) & (u >= 0) & (u < intr.width)
                & (v >= 0) & (v < intr.height))
        total += np.where(seen, w, 0.0)
        count += seen
        lightest = np.minimum(lightest, w)
    return np.where(count > 0, total / np.maximum(count, 1), lightest)


def layer_agreement(spec, a, b, obs_weight) -> dict:
    """Compare two TSDF layers voxel by voxel, matching blocks by their
    coordinates. ``obs_weight`` maps voxel centres (N,3) in the layers'
    frame to the weight of one observation there (observation_weights).
    → {block_set_equal, observed_both, frac_within (|Δsdf| ≤ SDF_TOL_M
    and |Δw| ≤ WEIGHT_TOL_OBS observations), frac_sdf_off,
    frac_weight_off, and the q90 / TAIL_Q quantiles and maxima of |Δsdf|
    (m) and |Δw| (observations), and both arrays} over the voxels
    observed in both."""
    import jax
    import jax.numpy as jnp

    from coxgraph_tpu.core import voxel as vx

    a = jax.tree.map(np.asarray, a)
    b = jax.tree.map(np.asarray, b)
    na, nb = int(a.num_blocks), int(b.num_blocks)
    ca, cb = a.block_coords[:na], b.block_coords[:nb]
    same = (na == nb and set(map(tuple, ca.tolist()))
            == set(map(tuple, cb.tolist())))
    h, g = spec.half_grid, spec.grid_dim
    flat = ((ca[:, 0] + h) * g + (ca[:, 1] + h)) * g + (ca[:, 2] + h)
    rows_b = b.block_index.reshape(-1)[flat]
    have = rows_b >= 0
    ra, rb = np.nonzero(have)[0], rows_b[have]
    wa, wb = a.weight[ra], b.weight[rb]
    both = (wa > 0) & (wb > 0)
    with jax.default_device(jax.devices("cpu")[0]):
        centers = np.asarray(vx.voxel_centers_of_block(
            spec, jnp.asarray(ca[ra]))).reshape(len(ra), -1, 3)
    unit = obs_weight(centers[both])
    dsdf = np.abs(a.sdf[ra] - b.sdf[rb])[both]
    dw = np.abs(wa - wb)[both] / unit
    within = (dsdf <= SDF_TOL_M) & (dw <= WEIGHT_TOL_OBS)

    def q(x, p):
        return float(np.quantile(x, p)) if x.size else float("inf")

    share = (lambda m: float(m.mean()) if m.size else 0.0)
    return {"block_set_equal": bool(same), "blocks": (na, nb),
            "observed_both": int(both.sum()),
            "frac_within": share(within),
            "frac_sdf_off": share(dsdf > SDF_TOL_M),
            "frac_weight_off": share(dw > WEIGHT_TOL_OBS),
            "q90_dsdf_m": q(dsdf, 0.9), "q90_dw_obs": q(dw, 0.9),
            "tail_dsdf_m": q(dsdf, TAIL_Q), "tail_dw_obs": q(dw, TAIL_Q),
            "max_dsdf_m": float(dsdf.max()) if dsdf.size else 0.0,
            "max_dw_obs": float(dw.max()) if dw.size else 0.0,
            "dsdf_m": dsdf, "dw_obs": dw}


def check_layer_agreement(rep: Report, what: str, agree: dict) -> None:
    rep.check(f"{what} allocated block set identical",
              f"{agree['block_set_equal']} {agree['blocks']}", "equal",
              agree["block_set_equal"])
    rep.check(f"{what} share of co-observed voxels within |dsdf|<="
              f"{SDF_TOL_M} m and |dw|<={WEIGHT_TOL_OBS} observations "
              f"({agree['observed_both']} voxels)",
              agree["frac_within"], f">= {MIN_SHARE}",
              agree["observed_both"] > 0
              and agree["frac_within"] >= MIN_SHARE)
    rep.check(f"{what} q{100 * TAIL_Q:g} |dsdf| m", agree["tail_dsdf_m"],
              f"<= {TAIL_SDF_TOL_M}", agree["tail_dsdf_m"] <= TAIL_SDF_TOL_M)
    rep.check(f"{what} q{100 * TAIL_Q:g} |dw| observations",
              agree["tail_dw_obs"], f"<= {TAIL_WEIGHT_TOL_OBS}",
              agree["tail_dw_obs"] <= TAIL_WEIGHT_TOL_OBS)
    rep.info(f"{what} share off in sdf, share off in weight",
             (agree["frac_sdf_off"], agree["frac_weight_off"]))
    rep.info(f"{what} max |dsdf| m, max |dw| observations",
             (agree["max_dsdf_m"], agree["max_dw_obs"]))


def pose_errors(a, b):
    """Max rotation (rad) and translation (m) error between pose sets."""
    from coxgraph_tpu.core import geometry as geo
    import jax.numpy as jnp

    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    err = np.asarray(geo.se3_log(jnp.asarray(geo.relative_np(a, b))))
    dt = np.linalg.norm(a[:, 4:7] - b[:, 4:7], axis=-1)
    return (float(np.linalg.norm(err[:, :3], axis=-1).max()),
            float(dt.max()))


def popcount_hamming(da: np.ndarray, db: np.ndarray) -> np.ndarray:
    """(Ka,8)×(Kb,8) uint32 → (Ka,Kb) Hamming distances in NumPy."""
    x = np.bitwise_xor(da[:, None, :], db[None, :, :])
    bytes_ = x.view(np.uint8)
    lut = np.array([bin(i).count("1") for i in range(256)], np.uint8)
    return lut[bytes_].reshape(x.shape[0], x.shape[1], -1).sum(
        -1, dtype=np.int64)


# ---------------------------------------------------------------------------
# one-GPU phases
# ---------------------------------------------------------------------------


class Ctx:
    """State handed from phase to phase."""

    def __init__(self, gpu, cpu, sizes: Sizes):
        self.gpu, self.cpu, self.sizes = gpu, cpu, sizes
        self.layer = None           # integrated GPU layer for serve


def phase_device(rep: Report, ctx: Ctx) -> None:
    import jax

    rep.check("platform", ctx.gpu.platform, "gpu", ctx.gpu.platform == "gpu")
    rep.info("device_kind", ctx.gpu.device_kind)
    rep.info("device count", len(jax.devices()))
    rep.info("jax", jax.__version__)


def _integrate_on(dev, cfg, depths, colors, traj):
    import jax
    import jax.numpy as jnp

    from coxgraph_tpu.mapper import submap_mapper as sm

    n = depths.shape[0]
    ts = np.arange(n, dtype=np.float32) * 0.05
    with jax.default_device(dev):
        args = [jax.device_put(x, dev) for x in
                (depths, colors.astype(np.float32), traj, ts)]
        s = sm.create_mapper(cfg)
        s = sm.start_submap(cfg, s, args[2][0], jnp.asarray(0.0))
        s = sm.integrate_batch(cfg, s, *args)
        layer = sm.get_layer(s.collection.layers, jnp.asarray(0))
        jax.block_until_ready(layer)
    return layer


def clip_observation_weights(cfg, traj):
    """observation_weights of a submap integrated from the camera poses
    ``traj`` (F,7) and anchored at the first of them."""
    from coxgraph_tpu.core import geometry as geo

    cams = geo.relative_np(np.asarray(traj[:1]), np.asarray(traj))
    return lambda c: observation_weights(cfg.intrinsics, cams, c)


def phase_integrate(rep: Report, ctx: Ctx) -> None:
    import jax

    from coxgraph_tpu.eval import benchmarks as bm

    z = ctx.sizes
    cfg = bm._mapper_config(z.scale)
    rep.info("config", f"{cfg.intrinsics.width}x{cfg.intrinsics.height}, "
             f"voxel {cfg.spec.voxel_size} m, {cfg.spec.voxels_per_side}^3 "
             f"blocks, truncation {cfg.spec.truncation} m, max range "
             f"{cfg.integrator.max_range} m, {z.integrate_frames} frames")
    with jax.default_device(ctx.gpu):
        depths, colors, traj = bm.render_frames(z.integrate_frames, z.scale)
    t0 = time.perf_counter()
    layer_g = _integrate_on(ctx.gpu, cfg, depths, colors, traj)
    rep.info("gpu first window (compile + run) s", time.perf_counter() - t0)
    t0 = time.perf_counter()
    layer_g = _integrate_on(ctx.gpu, cfg, depths, colors, traj)
    dt = time.perf_counter() - t0
    rep.info("gpu window s (fresh map, create + integrate + slice)", dt)
    layer_c = _integrate_on(ctx.cpu, cfg, depths, colors, traj)
    check_layer_agreement(rep, "gpu vs cpu", layer_agreement(
        cfg.spec, layer_g, layer_c, clip_observation_weights(cfg, traj)))
    # the submap is anchored at the first camera pose (world frame)
    ctx.layer, ctx.cfg, ctx.T_world_submap = layer_g, cfg, traj[0]


def phase_serve(rep: Report, ctx: Ctx) -> None:
    import jax
    import jax.numpy as jnp

    from coxgraph_tpu.core import geometry as geo, voxel as vx
    from coxgraph_tpu.frontends import synthetic as syn
    from coxgraph_tpu.ops import esdf as esdf_ops
    from coxgraph_tpu.ops import merge as merge_ops
    from coxgraph_tpu.ops import mesh as mesh_ops
    from coxgraph_tpu.ops.mesh_incremental import IncrementalMesher

    spec = ctx.cfg.spec
    lg = ctx.layer
    lc = jax.device_put(lg, ctx.cpu)
    scene = syn.default_scene()

    # mesh
    with jax.default_device(ctx.gpu):
        vg, _ = mesh_ops.extract_mesh(spec, lg, quantize=False)
    with jax.default_device(ctx.cpu):
        vc, _ = mesh_ops.extract_mesh(spec, lc, quantize=False)
        vw = geo.transform_points_np(ctx.T_world_submap, vg.reshape(-1, 3))
        err = np.abs(np.asarray(syn.scene_sdf(scene, jnp.asarray(vw))))
    rel = abs(vg.shape[0] - vc.shape[0]) / max(vc.shape[0], 1)
    rep.check(f"extract_mesh triangles gpu {vg.shape[0]} vs cpu "
              f"{vc.shape[0]}, relative difference", rel, "<= 0.005",
              vg.shape[0] > 0 and rel <= 0.005)
    q90 = float(np.quantile(err, 0.9)) if err.size else float("inf")
    rep.check("mesh q90 |scene_sdf(vertex)| m", q90,
              f"< 1.5 voxels = {1.5 * spec.voxel_size}",
              q90 < 1.5 * spec.voxel_size)

    # incremental mesher == extract_mesh
    with jax.default_device(ctx.gpu):
        m = IncrementalMesher(spec, quantize=False)
        m.update(lg, jnp.ones((spec.max_blocks,), bool))
        vi, _ = m.mesh()
    same = vi.shape == vg.shape and np.array_equal(vi, vg)
    rep.check("incremental mesher output identical to extract_mesh",
              f"{vi.shape[0]} vs {vg.shape[0]} triangles", "identical", same)

    # ESDF
    with jax.default_device(ctx.gpu):
        eg = esdf_ops.esdf_from_tsdf(spec, lg)
        jax.block_until_ready(eg.dist)
    with jax.default_device(ctx.cpu):
        ec = esdf_ops.esdf_from_tsdf(spec, lc)
    dg, dc = np.asarray(eg.dist), np.asarray(ec.dist)
    near = (np.asarray(eg.observed) & np.asarray(ec.observed)
            & (np.abs(dc) < 4 * spec.truncation))
    d = np.abs(dg - dc)[near]
    q99 = float(np.quantile(d, 0.99)) if d.size else float("inf")
    rep.check(f"esdf q99 |gpu - cpu| m over {int(near.sum())} near-band "
              f"voxels (|d| < {4 * spec.truncation} m)", q99, "<= 1e-4",
              d.size > 0 and q99 <= 1e-4)
    rep.info("esdf max |gpu - cpu| m", float(d.max()) if d.size else None)

    # merge: identity-pose round trip into an empty layer, GPU vs CPU
    dst_spec = dataclasses.replace(spec, max_blocks=2 * spec.max_blocks)

    def merge_on(dev, layer):
        with jax.default_device(dev):
            return merge_ops.merge_layer_into_sized(
                dst_spec, vx.create_tsdf_layer(dst_spec), layer,
                geo.identity(), src_spec=spec)

    # the round trip reproduces the source up to the merge's bf16
    # (sdf, weight) packing: 8 mantissa bits of a value ≤ truncation.
    # Gated on a quantile: a voxel centre lies on the source lattice, and
    # a few percent of them sample a neighbouring voxel (open question in
    # ROADMAP.md); the CPU reference's share is printed beside.
    tol = spec.truncation * 2.0 ** -8
    src = jax.tree.map(np.asarray, lg)
    for name, dev, layer in (("gpu", ctx.gpu, lg), ("cpu", ctx.cpu, lc)):
        mg = jax.tree.map(np.asarray, merge_on(dev, layer))
        n = int(src.num_blocks)
        h, g = dst_spec.half_grid, dst_spec.grid_dim
        c = src.block_coords[:n]
        rows = mg.block_index.reshape(-1)[
            ((c[:, 0] + h) * g + (c[:, 1] + h)) * g + (c[:, 2] + h)]
        rep.check(f"merge round trip {name}: every source block allocated",
                  int((rows >= 0).sum()), f"== {n}", bool((rows >= 0).all()))
        rows = np.maximum(rows, 0)
        # a merged voxel needs all 8 trilinear corners observed
        both = (src.weight[:n] > 0) & (mg.weight[rows] > 0)
        dsd = np.abs(mg.sdf[rows] - src.sdf[:n])[both]
        q90 = float(np.quantile(dsd, 0.9)) if dsd.size else float("inf")
        rep.check(f"merge round trip {name} q90 |dsdf| m over {dsd.size} "
                  "merged voxels", q90, f"<= {tol:.3e}", q90 <= tol)
        rep.info(f"merge round trip {name}: share of observed source "
                 "voxels merged, share within tolerance, max |dsdf| m",
                 (float(both.sum() / max((src.weight[:n] > 0).sum(), 1)),
                  float((dsd <= tol).mean()) if dsd.size else None,
                  float(dsd.max()) if dsd.size else None))


def chain_relative_errors(a, b, steps=(1, 2)):
    """Max rotation (rad) and translation (m) difference between the
    relative poses of submaps k and k+step of two pose chains (N,7)."""
    from coxgraph_tpu.core import geometry as geo

    a, b = np.asarray(a), np.asarray(b)
    rel = (lambda p, s: geo.relative_np(p[:-s], p[s:]))
    errs = [pose_errors(rel(a, s), rel(b, s)) for s in steps]
    return max(e[0] for e in errs), max(e[1] for e in errs)


# Pose tolerances of the solve phase, on the relative poses of submaps k,
# k+1 and k, k+2 (chain_relative_errors): along the 50 m chain a tiny
# rotation difference in one link swings the far end by its lever arm,
# and the GPU's scatter-adds (atomics) sum in a run-dependent order. H100
# against the CPU, pose graph alone: 4.2e-6 to 6.8e-6 rad / 7.6e-6 m
# relative over three runs (1.6 to 2.7 mm absolute at the far end); with
# its normal equations at default precision (TF32) 7.8e-5 rad / 2.6e-5 m
# relative (2.7 cm absolute). Two-phase: 1.3e-4 rad / 9.1e-5 m
# (tools/smoke_faults.py; PERF.md).
PGO_TOL_RAD = 2.5e-5
PGO_TOL_M = 1e-4
PAIR_TOL_RAD = 1e-3
PAIR_TOL_M = 1e-3


def phase_solve(rep: Report, ctx: Ctx) -> None:
    """eval/benchmarks.solve_benchmark_problem, GPU against CPU, in two
    parts:

    - the pose-graph solve alone (solver/pose_graph.optimize) over the
      benchmark's 64-submap odometry chain closed by the true relative
      pose of every second submap: the relative pose of submaps k, k+1
      and k, k+2 within PGO_TOL;
    - optimize_two_phase at the bench's 6 registration iterations: the
      relative pose of every registered pair (submaps k, k+1 and k, k+2)
      within PAIR_TOL and the final cost within a relative 1e-3. Absolute
      poses are printed, not gated: along the 50 m chain a 1e-4 rad
      difference in one link swings the far end by centimetres (on the
      CPU alone a 1e-7 m nudge of the initial poses moves the end 6.6 cm
      but every registered pair by at most 1.2e-4 rad / 8.9e-5 m)."""
    import jax
    import jax.numpy as jnp

    from coxgraph_tpu.core import geometry as geo
    from coxgraph_tpu.eval import benchmarks as bm
    from coxgraph_tpu.server import global_opt
    from coxgraph_tpu.solver import pose_graph as pg

    n = ctx.sizes.solve_submaps
    with jax.default_device(ctx.cpu):
        problem = bm.solve_benchmark_problem(n)
        true = np.stack([np.asarray(geo.from_xyzyaw(jnp.asarray(
            [k * bm.SOLVE_SPACING, 0.0, 0.0, 0.0]))) for k in range(n)])
        init, cons, layers, spec, reg_cfg, solver_cfg, fixed = problem
        closed = cons
        for k in range(n - 2):
            closed = closed.add(k, k + 2, jnp.asarray(
                geo.relative_np(true[k], true[k + 2])), 10.0 * jnp.eye(6))

    def pgo(dev):
        with jax.default_device(dev):
            args = jax.device_put((init, closed, fixed), dev)
            return np.asarray(pg.optimize(args[0], args[1], solver_cfg,
                                          fixed=args[2]).poses)

    pose_g, pose_c = pgo(ctx.gpu), pgo(ctx.cpu)
    drot, dtr = chain_relative_errors(pose_g, pose_c)
    rep.check(f"pose graph alone ({n} poses, {2 * n - 3} constraints): "
              "relative poses of submaps k, k+1 and k, k+2, max difference "
              "gpu vs cpu: rotation rad", drot, f"<= {PGO_TOL_RAD}",
              drot <= PGO_TOL_RAD)
    rep.check("pose graph alone: relative poses, max difference gpu vs cpu:"
              " translation m", dtr, f"<= {PGO_TOL_M}", dtr <= PGO_TOL_M)
    rep.info("pose graph alone: absolute poses, max difference gpu vs cpu "
             "(rad, m)", pose_errors(pose_g, pose_c))

    def solve(dev):
        with jax.default_device(dev):
            args = jax.device_put((init, cons, layers, fixed), dev)
            poses, info = global_opt.optimize_two_phase(
                args[0], args[1], spec, args[2], reg_cfg=reg_cfg,
                solver_cfg=solver_cfg, registration_weight=30.0,
                reg_iterations=6, fixed=args[3])
            return np.asarray(poses), info

    solve(ctx.gpu)
    t0 = time.perf_counter()
    pg6, info = solve(ctx.gpu)
    rep.info("gpu two-phase solve s (warm, 6 registration iterations)",
             time.perf_counter() - t0)
    rep.info("submaps, registration pairs", (n, info["n_registration_pairs"]))
    pc6, info_c = solve(ctx.cpu)
    cost_g, cost_c = (float(info["phase2_relpose_cost"]),
                      float(info_c["phase2_relpose_cost"]))
    rel = abs(cost_g - cost_c) / max(abs(cost_c), 1e-30)
    rep.check(f"two-phase final relative-pose cost gpu {cost_g} vs cpu "
              f"{cost_c}, relative difference", rel, "<= 1e-3", rel <= 1e-3)
    drot, dtr = chain_relative_errors(pg6, pc6)
    rep.check("two-phase registered pairs' relative poses, max difference "
              "gpu vs cpu: rotation rad", drot, f"<= {PAIR_TOL_RAD}",
              drot <= PAIR_TOL_RAD)
    rep.check("two-phase registered pairs' relative poses, max difference "
              "gpu vs cpu: translation m", dtr, f"<= {PAIR_TOL_M}",
              dtr <= PAIR_TOL_M)
    rep.info("two-phase absolute poses, max difference gpu vs cpu (rad, m)",
             pose_errors(pg6, pc6))


def phase_detect(rep: Report, ctx: Ctx) -> None:
    import jax
    import jax.numpy as jnp

    from coxgraph_tpu.ops import features as ft

    z = ctx.sizes
    rng = np.random.default_rng(0)
    q = rng.integers(0, 2 ** 32, (z.detect_keypoints, 8), dtype=np.uint32)
    db = rng.integers(0, 2 ** 32, (z.detect_keyframes, z.detect_keypoints,
                                   8), dtype=np.uint32)

    @jax.jit
    def both(q, db):
        mm = jax.vmap(ft.hamming_matrix, (None, 0))(q, db)
        pc = jax.lax.population_count(
            jnp.bitwise_xor(q[None, :, None, :], db[:, None, :, :])
        ).astype(jnp.int32).sum(-1)
        return mm, jnp.sum(mm != pc)

    with jax.default_device(ctx.gpu):
        mm, n_diff = both(jax.device_put(q, ctx.gpu),
                          jax.device_put(db, ctx.gpu))
        n_diff = int(n_diff)
    rep.check(f"hamming_matrix vs device integer popcount over "
              f"{z.detect_keyframes}x{z.detect_keypoints}x"
              f"{z.detect_keypoints} distances, mismatches", n_diff, "== 0",
              n_diff == 0)
    k = z.detect_numpy_keyframes
    got = np.asarray(mm[:k])
    want = np.stack([popcount_hamming(q, db[i]) for i in range(k)])
    bad = int((got != want).sum())
    rep.check(f"hamming_matrix vs NumPy popcount on {k} keyframes, "
              "mismatches", bad, "== 0", bad == 0)


def phase_mission(rep: Report, ctx: Ctx) -> None:
    import jax

    from coxgraph_tpu.eval.mission import two_robot_mission

    z = ctx.sizes
    with jax.default_device(ctx.gpu):
        m = two_robot_mission(z.mission_frames, z.scale)
    rep.info("reduction", f"{m['frames_per_robot']} frames per robot, "
             f"submap interval {m['submap_interval_s']:.4f} s, "
             f"{m['width']}x{m['height']} (loop detector at "
             f"{m['detector_width']} px wide)")
    for k in ("stream_wall_s", "solve_wall_s", "final_mesh_wall_s",
              "server_submaps", "client1_align_rot", "client1_align_trans",
              "surface_err_p50_m", "ate_aligned_m", "bytes_shipped"):
        rep.info(k, m[k])
    for f in m["fusion_log"]:
        rep.info("fusion offered (from, to, accepted, rot err rad, "
                 "trans err m)", f)
    rep.check("fusions", m["fusions"], "> 0", m["fusions"] > 0)
    rep.check("optimize_errors", m["optimize_errors"], "empty",
              not m["optimize_errors"])
    for r, ate in enumerate(m["ate_m"]):
        rep.check(f"client {r} global-frame ATE m", ate, "< 0.13",
                  ate < 0.13)
    rep.check("final mesh triangles", m["mesh_tris"], "> 1000",
              m["mesh_tris"] > 1000)
    rep.check("final mesh surface error p90 m", m["surface_err_p90_m"],
              "< 4 voxels = 0.2", m["surface_err_p90_m"] < 0.2)


ONE_GPU_PHASES = (("device", phase_device), ("integrate", phase_integrate),
                  ("serve", phase_serve), ("solve", phase_solve),
                  ("detect", phase_detect), ("mission", phase_mission))


# ---------------------------------------------------------------------------
# four-GPU fleet path
# ---------------------------------------------------------------------------


def _fleet_config(z: Sizes):
    from coxgraph_tpu.core import voxel as vx
    from coxgraph_tpu.frontends import synthetic as syn
    from coxgraph_tpu.mapper import submap_mapper as sm
    from coxgraph_tpu.ops import tsdf as tsdf_ops

    return sm.MapperConfig(
        spec=vx.VoxelGridSpec(voxel_size=0.05, voxels_per_side=16,
                              grid_dim=64, max_blocks=2048, truncation=0.15),
        integrator=tsdf_ops.TsdfIntegratorConfig(max_touched_blocks=1024),
        intrinsics=syn.PinholeIntrinsics().scaled(z.scale),
        max_submaps=3, max_history=16,
        # frames at t = 0.12·f: submap k starts at frame 2k
        submap_interval=0.2, max_constraints=16)


def phase_fleet(rep: Report, ctx: "FleetCtx") -> None:
    import jax
    import jax.numpy as jnp

    from coxgraph_tpu.core import geometry as geo
    from coxgraph_tpu.frontends import synthetic as syn
    from coxgraph_tpu.mapper import submap_mapper as sm
    from coxgraph_tpu.parallel import fleet as fl

    z, devs = ctx.sizes, ctx.devs
    R, F = len(devs), z.fleet_frames
    cfg = _fleet_config(z)
    ctx.cfg = cfg
    rep.info("config", f"{R} robots, {cfg.intrinsics.width}x"
             f"{cfg.intrinsics.height}, voxel {cfg.spec.voxel_size} m, "
             f"{F} frames per robot, {cfg.max_submaps} submaps each")
    scene = syn.default_scene()
    rng = np.random.default_rng(11)
    H, W = cfg.intrinsics.height, cfg.intrinsics.width
    true_T = np.zeros((F, R, 7), np.float32)
    odom_T = np.zeros((F, R, 7), np.float32)
    depths = np.zeros((F, R, H, W), np.float32)
    colors = np.zeros((F, R, H, W, 3), np.float32)
    with jax.default_device(devs[0]):
        for r in range(R):
            traj = syn.orbit_trajectory(F, scene.room_center, radius=2.4,
                                        sweep=0.3 * jnp.pi,
                                        start_angle=2 * jnp.pi * r / R)
            drift = np.asarray(geo.identity())
            for f in range(F):
                d, c = syn.render_depth(scene, cfg.intrinsics, traj[f])
                depths[f, r], colors[f, r] = np.asarray(d), np.asarray(c)
                true_T[f, r] = np.asarray(traj[f])
                odom_T[f, r] = geo.compose_np(drift, true_T[f, r])
                drift = geo.compose_np(drift, np.asarray(geo.se3_exp(
                    jnp.asarray(rng.normal(0, 0.01, 6), jnp.float32))))
    ts = 0.12 * np.arange(F, dtype=np.float32)
    mesh = fl.make_robot_mesh(R)
    fleet = fl.shard_fleet(fl.create_fleet(cfg, R), mesh)
    t0 = time.perf_counter()
    for f in range(F):
        fleet = fl.fleet_step(cfg, mesh, fleet, jnp.asarray(depths[f]),
                              jnp.asarray(colors[f]), jnp.asarray(odom_T[f]),
                              jnp.full((R,), ts[f]))
    jax.block_until_ready(fleet.frame_count)
    rep.info("fleet integrate s (incl. compile)", time.perf_counter() - t0)
    nsub = np.asarray(fleet.collection.num_submaps)
    rep.check("submaps per robot", nsub.tolist(), f"== {cfg.max_submaps}",
              bool((nsub == cfg.max_submaps).all()))

    # reference: the single-robot mapper per robot on one device
    for r in range(R):
        with jax.default_device(devs[0]):
            ref = sm.create_mapper(cfg)
            for f in range(F):
                ref, _ = sm.mapper_step(cfg, ref, jnp.asarray(depths[f, r]),
                                        jnp.asarray(colors[f, r]),
                                        jnp.asarray(odom_T[f, r]),
                                        float(ts[f]))
        got = fl.robot_state(fleet, r)
        T_sub = np.asarray(ref.collection.T_odom_submap)
        for k in range(cfg.max_submaps):
            la = sm.get_layer(got.collection.layers, jnp.asarray(k))
            lb = sm.get_layer(ref.collection.layers, jnp.asarray(k))
            cams = geo.relative_np(T_sub[k:k + 1], odom_T[:, r])
            check_layer_agreement(
                rep, f"robot {r} submap {k} fleet vs single device",
                layer_agreement(cfg.spec, la, lb, lambda c: observation_weights(
                    cfg.intrinsics, cams, c)))
    ctx.fleet, ctx.mesh, ctx.true_T, ctx.odom_T = fleet, mesh, true_T, odom_T


def phase_fleet_pgo(rep: Report, ctx: "FleetCtx") -> None:
    import jax
    import jax.numpy as jnp

    from coxgraph_tpu.core import geometry as geo
    from coxgraph_tpu.parallel import fleet as fl
    from coxgraph_tpu.solver import pose_graph as pg

    cfg, fleet, true_T = ctx.cfg, ctx.fleet, ctx.true_T
    R, S = len(ctx.devs), cfg.max_submaps
    # closures from TRUE poses: intra-robot (submap 0 ↔ last, whose
    # first frame is 2·(S-1)) and inter-robot (consecutive robots'
    # submap 0)
    last = 2 * (S - 1)
    inter = pg.RelPoseConstraints.empty(2 * R + 4)
    for r in range(R):
        inter = inter.add(r * S, r * S + S - 1, jnp.asarray(geo.relative_np(
            true_T[0, r], true_T[last, r])), 10.0 * jnp.eye(6))
    for r in range(R - 1):
        inter = inter.add(r * S, (r + 1) * S, jnp.asarray(geo.relative_np(
            true_T[0, r], true_T[0, r + 1])), 10.0 * jnp.eye(6))
    solver = pg.SolverConfig(iterations=10)
    poses0 = np.asarray(fleet.collection.T_odom_submap).reshape(R * S, 7)
    local = jax.tree.map(np.asarray, fl.globalize_constraints(
        fleet.constraints, S))
    _, poses = fl.fleet_optimize(cfg, ctx.mesh, fleet, inter, solver)
    poses = np.asarray(poses)
    # reference: the dense single-device LM over the same graph
    merged = pg.RelPoseConstraints(
        i=np.concatenate([local.i.reshape(-1), np.asarray(inter.i)]),
        j=np.concatenate([local.j.reshape(-1), np.asarray(inter.j)]),
        T_meas=np.concatenate([local.T_meas.reshape(-1, 7),
                               np.asarray(inter.T_meas)]),
        sqrt_info=np.concatenate([local.sqrt_info.reshape(-1, 6, 6),
                                  np.asarray(inter.sqrt_info)]),
        valid=np.concatenate([local.valid.reshape(-1),
                              np.asarray(inter.valid)]),
        count=np.asarray(int(local.count.sum()) + int(inter.count)))
    with jax.default_device(ctx.devs[0]):
        ref = pg.optimize(jnp.asarray(poses0), jax.device_put(
            merged, ctx.devs[0]), solver)
        ref_poses = np.asarray(ref.poses)
    rep.check("distributed solve finite", bool(np.isfinite(poses).all()),
              "True", bool(np.isfinite(poses).all()))
    drot, dtr = pose_errors(poses, ref_poses)
    rep.check("distributed vs single-device solve: rotation rad", drot,
              "<= 1e-3", drot <= 1e-3)
    rep.check("distributed vs single-device solve: translation m", dtr,
              "<= 1e-3", dtr <= 1e-3)


def phase_fleet_esdf(rep: Report, ctx: "FleetCtx") -> None:
    import jax
    import jax.numpy as jnp

    from coxgraph_tpu.core import voxel as vx
    from coxgraph_tpu.ops import esdf as esdf_ops
    from coxgraph_tpu.parallel import esdf_sharded as es

    spec = dataclasses.replace(ctx.cfg.spec, max_blocks=640)
    with jax.default_device(ctx.devs[0]):
        layer = vx.create_tsdf_layer(spec)
        r8 = np.arange(-4, 4)
        bx, by, bz = np.meshgrid(r8, r8, r8, indexing="ij")
        layer = vx.allocate_blocks(spec, layer, jnp.asarray(
            np.stack([bx, by, bz], -1).reshape(-1, 3), jnp.int32))
        centers = vx.voxel_centers_of_block(spec, layer.block_coords)
        true = jnp.linalg.norm(centers - jnp.asarray([0.05, -0.1, 0.0]),
                               axis=-1) - 1.2
        live = (jnp.arange(spec.max_blocks) < layer.num_blocks)[:, None]
        layer = dataclasses.replace(
            layer,
            sdf=jnp.where(live, jnp.clip(true, -spec.truncation,
                                         spec.truncation).reshape(
                spec.max_blocks, -1), layer.sdf),
            weight=jnp.where(live, jnp.ones_like(layer.weight), 0.0))
        ecfg = esdf_ops.EsdfConfig(max_distance=1.0)
        ref = esdf_ops.esdf_from_tsdf(spec, layer, ecfg)
        want = np.asarray(ref.dist)
    scfg = es.ShardedEsdfConfig(per_device_blocks=320, halo_blocks=64,
                                esdf=ecfg)
    parts = es.partition_blocks(spec, layer, len(ctx.devs), scfg)
    dist = es.esdf_sharded(spec, ctx.mesh, parts, scfg)
    got = np.asarray(es.gather_to_layer(spec, layer, parts, dist).dist)
    n = int(layer.num_blocks)
    d = np.abs(got[:n] - want[:n])
    rep.check(f"sharded vs single-device ESDF over {n} blocks: max |d| m",
              float(d.max()), "<= 1e-4", float(d.max()) <= 1e-4)


def phase_fleet_merge(rep: Report, ctx: "FleetCtx") -> None:
    import jax
    import jax.numpy as jnp

    from coxgraph_tpu.core import voxel as vx
    from coxgraph_tpu.mapper import submap_mapper as sm
    from coxgraph_tpu.ops import merge as merge_ops
    from coxgraph_tpu.parallel import fleet as fl
    from coxgraph_tpu.parallel import merge_sharded as msh

    cfg, R = ctx.cfg, len(ctx.devs)
    spec = dataclasses.replace(cfg.spec,
                               max_blocks=ctx.sizes.merge_max_blocks)
    layers, poses = [], []
    for r in range(R):
        st = fl.robot_state(ctx.fleet, r)
        for k in range(cfg.max_submaps):
            # host copies: the sharded merge places its inputs itself
            layers.append(jax.tree.map(np.asarray, sm.get_layer(
                st.collection.layers, jnp.asarray(k))))
            poses.append(np.asarray(st.collection.T_odom_submap)[k])
    merged = msh.merge_layers_sharded(spec, ctx.mesh, layers, poses,
                                      max_touched=spec.max_blocks,
                                      src_spec=cfg.spec)
    with jax.default_device(ctx.devs[0]):
        seq = vx.create_tsdf_layer(spec)
        for la, T in zip(layers, poses):
            seq = merge_ops.merge_layer_into(spec, seq, la, T,
                                             max_touched=spec.max_blocks,
                                             src_spec=cfg.spec)
    # gated on quantiles: the sequential and sharded programs sample a
    # few percent of voxels from a neighbouring source voxel (the open
    # merge-sampling question in ROADMAP.md); shares and maxima printed
    cams = ctx.odom_T.reshape(-1, 7)
    agree = layer_agreement(spec, merged, seq, lambda c: observation_weights(
        cfg.intrinsics, cams, c))
    rep.info("merged blocks sharded, sequential (block sets equal)",
             (agree["blocks"], agree["block_set_equal"]))
    rep.info(f"share of co-observed voxels within |dsdf|<={SDF_TOL_M} m and "
             f"|dw|<={WEIGHT_TOL_OBS} observations "
             f"({agree['observed_both']} voxels)", agree["frac_within"])
    rep.info("max |dsdf| m, max |dw| observations",
             (agree["max_dsdf_m"], agree["max_dw_obs"]))
    rep.check("sharded vs sequential merge q90 |dsdf| m",
              agree["q90_dsdf_m"], f"<= {SDF_TOL_M}",
              agree["q90_dsdf_m"] <= SDF_TOL_M)
    rep.check("sharded vs sequential merge q90 |dw| observations",
              agree["q90_dw_obs"], f"<= {WEIGHT_TOL_OBS}",
              agree["q90_dw_obs"] <= WEIGHT_TOL_OBS)


class FleetCtx:
    def __init__(self, devs, sizes: Sizes):
        self.devs, self.sizes = devs, sizes


FOUR_GPU_PHASES = (("fleet", phase_fleet), ("fleet_pgo", phase_fleet_pgo),
                   ("fleet_esdf", phase_fleet_esdf),
                   ("fleet_merge", phase_fleet_merge))


def run_phases(phases, ctx, mem_device) -> Report:
    rep = Report(mem_device)
    for name, fn in phases:
        rep.run(name, fn, ctx)
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the fleet path over four GPUs")
    args = ap.parse_args(argv)
    n_gpus = 4 if args.four_gpus else 1

    import jax

    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if len(gpus) < n_gpus:
        print(f"chip_smoke: needs {n_gpus} GPU(s), JAX found {len(gpus)} "
              f"(backend {jax.default_backend()!r}); no CPU fallback",
              file=sys.stderr)
        return 2

    from coxgraph_tpu.utils import runtime

    runtime.enable_compilation_cache()
    print(f"card: {runtime.gpu_card_line()}", flush=True)
    if args.four_gpus:
        rep = run_phases(FOUR_GPU_PHASES, FleetCtx(gpus[:4], Sizes()),
                         gpus[0])
    else:
        rep = run_phases(ONE_GPU_PHASES,
                         Ctx(gpus[0], jax.devices("cpu")[0], Sizes()),
                         gpus[0])
    if rep.failed:
        print("chip_smoke: FAILED: " + "; ".join(rep.failed),
              file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
