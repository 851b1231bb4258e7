"""Benchmark problem generators + measurement bodies shared by bench.py,
chip_smoke.py and tests.

Two headline measurements (BASELINE.md "TSDF+ICP ≥5×/chip"):

- TSDF integration throughput: the per-robot streaming hot path
  (mapper.integrate_batch) on the reference operating point — 640×480
  RGB-D @ 5 cm voxels, 0.15 m truncation, 10 m max range
  (eval_data_publisher.h:23-31 measurement-hook spirit).
- Two-phase registration solve: the server's optimizePoseGraph budget at
  64 submaps / 100+ overlapping pairs / 6 LM iterations — the
  reference's Ceres wall budget is ≤4 s (pose_graph.h:57-68).

Every timing fences on a device→host readback of data produced by the
timed computation, and each measurement warms its one program shape
first (ONE integrate_batch window shape here).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FRAMES_CACHE = os.path.join(REPO, ".bench_frames.npz")
N_FRAMES = 30
SCALE = 1.0  # 640x480


def _mapper_config(scale: float = SCALE):
    from ..core import voxel as vx
    from ..frontends import synthetic as syn
    from ..mapper import submap_mapper as sm
    from ..ops import tsdf as tsdf_ops

    return sm.MapperConfig(
        spec=vx.VoxelGridSpec(voxel_size=0.05, voxels_per_side=16,
                              grid_dim=64, max_blocks=2048,
                              truncation=0.15),
        # per-frame touched-block capacity sized to the scene (a frame of
        # this clip touches ~350 blocks; capacity is the fixed-shape
        # bound). alloc_stride 8: at 640×480 a block's pixel footprint
        # is ≥40 px, so stride 8 still lands ≥5 samples per block and
        # quarters the allocation-sort cost (see TsdfIntegratorConfig).
        integrator=tsdf_ops.TsdfIntegratorConfig(max_touched_blocks=512,
                                                 alloc_stride=8),
        intrinsics=syn.PinholeIntrinsics().scaled(scale),
        max_submaps=4,
        max_history=1024,
        submap_interval=1e9,  # single submap: pure integration throughput
    )


def render_frames(n_frames: int = N_FRAMES, scale: float = SCALE):
    """Render the bench clip → host arrays (depths (N,H,W) f32, colors
    (N,H,W,3) f16 in [0,1], traj (N,7) f32)."""
    from ..frontends import synthetic as syn

    intr = syn.PinholeIntrinsics().scaled(scale)
    scene = syn.default_scene()
    traj = syn.orbit_trajectory(n_frames, scene.room_center, radius=2.5)
    ds, cs = [], []
    for i in range(n_frames):
        d, c = syn.render_depth(scene, intr, traj[i])
        ds.append(np.asarray(d))
        cs.append(np.asarray(c, np.float16))  # color ∈ [0,1]: f16 halves
        #                                       the cache + transfer bytes
    return np.stack(ds), np.stack(cs), np.asarray(traj)


def generate_frames(path: str = FRAMES_CACHE, n_frames: int = N_FRAMES
                    ) -> None:
    """Render the bench clip and cache it to disk (frame generation is
    input pipeline, not the metric)."""
    d, c, t = render_frames(n_frames)
    np.savez(path, depths=d, colors=c, traj=t)


def load_frames(path: str = FRAMES_CACHE):
    """→ (depths (N,H,W) f32, colors (N,H,W,3) f32, traj (N,7) f32) on
    device."""
    import jax.numpy as jnp

    f = np.load(path)
    return (jnp.asarray(f["depths"], jnp.float32),
            jnp.asarray(f["colors"], jnp.float32),
            jnp.asarray(f["traj"], jnp.float32))


def tsdf_benchmark(depths, colors, traj, n_frames: int | None = None,
                   windows: int = 4) -> float:
    """Measure streaming TSDF integration on the current backend →
    sustained frames/s. ONE kernel-bearing program (a single
    integrate_batch window shape): warm it, then time ``windows``
    back-to-back window dispatches of a fresh-map run with ONE readback
    fence at the end. The windows chain through the donated mapper
    state, so the final checksum proves every window executed — the
    sustained rate of the streaming pipeline, where a steady-state robot
    never blocks on a readback per window.

    Re-feeding the same clip does NOT skip allocation work on later
    windows: the window is ONE fixed jitted program (static shapes,
    static top_k/scatter work, lax control flow), so its device cost is
    data-independent — whether allocation finds new or existing blocks,
    the same ops execute."""
    import jax
    import jax.numpy as jnp

    from ..mapper import submap_mapper as sm

    cfg = _mapper_config()
    n = n_frames or depths.shape[0]
    depths, colors, traj = depths[:n], colors[:n], traj[:n]
    ts = jnp.arange(n, dtype=jnp.float32) * 0.05

    def checksum(s):
        # device→host readback of data the timed windows produced
        return float(jnp.sum(s.collection.layers.weight))

    def fresh():
        s = sm.create_mapper(cfg)
        return sm.start_submap(cfg, s, traj[0], jnp.asarray(0.0))

    # warmup / compile of the one window shape
    state = fresh()
    state = sm.integrate_batch(cfg, state, depths, colors, traj, ts)
    checksum(state)

    # measured: windows back-to-back (same clip re-fed — identical
    # program/shape to a streaming feed), one fence at the end
    state = fresh()
    jax.block_until_ready(state.collection.layers.weight)
    t0 = time.perf_counter()
    for _ in range(windows):
        state = sm.integrate_batch(cfg, state, depths, colors, traj, ts)
    checksum(state)
    return n * windows / (time.perf_counter() - t0)


def stage_benchmark(depths, colors, traj) -> dict:
    """Non-TSDF hot-stage timings over the bench map (VERDICT r3 #7 —
    regressions in ESDF / meshing should land in the round artifact, the
    reference's first-class measurement hooks, eval_data_publisher.h:23-31):
    warm-then-timed batch ESDF build and mesh extraction (device +
    quantized readback)."""
    import jax
    import jax.numpy as jnp

    from ..mapper import submap_mapper as sm
    from ..ops import esdf as esdf_ops
    from ..ops import mesh as mesh_ops

    cfg = _mapper_config()
    n = depths.shape[0]
    ts = jnp.arange(n, dtype=jnp.float32) * 0.05
    s = sm.create_mapper(cfg)
    s = sm.start_submap(cfg, s, traj[:n][0], jnp.asarray(0.0))
    s = sm.integrate_batch(cfg, s, depths[:n], colors[:n], traj[:n], ts)
    layer = sm._get_layer(s.collection.layers, jnp.asarray(0))
    float(jnp.sum(layer.weight))
    out = {}

    e = esdf_ops.esdf_from_tsdf(cfg.spec, layer)            # warm
    float(jnp.sum(e.dist))
    t0 = time.perf_counter()
    e = esdf_ops.esdf_from_tsdf(cfg.spec, layer)
    float(jnp.sum(e.dist))                                  # fence
    out["esdf_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
    out["esdf_blocks"] = int(layer.num_blocks)

    v, c = mesh_ops.extract_mesh(cfg.spec, layer, min_weight=0.1)  # warm
    t0 = time.perf_counter()
    v, c = mesh_ops.extract_mesh(cfg.spec, layer, min_weight=0.1)
    out["mesh_extract_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
    out["mesh_tris"] = int(v.shape[0])

    # layer merge (the final-global-mesh serving stage, sized working
    # set — merge_layer_into_sized)
    from ..core import geometry as geo, voxel as vx
    from ..ops import merge as merge_ops
    import dataclasses as _dc

    dst_spec = _dc.replace(cfg.spec, max_blocks=2 * cfg.spec.max_blocks)
    pose = geo.identity()
    # destination layers built OUTSIDE the timed region (the merge
    # donates its dst, so the warm and timed calls each need a fresh
    # one) — the ~167 MB pool zero-fill is layer creation, not merge
    dst_warm = vx.create_tsdf_layer(dst_spec)
    dst_timed = vx.create_tsdf_layer(dst_spec)
    jax.block_until_ready(dst_timed.weight)
    dst = merge_ops.merge_layer_into_sized(
        dst_spec, dst_warm, layer, pose, src_spec=cfg.spec)  # warm
    float(jnp.sum(dst.weight))
    t0 = time.perf_counter()
    dst = merge_ops.merge_layer_into_sized(
        dst_spec, dst_timed, layer, pose, src_spec=cfg.spec)
    float(jnp.sum(dst.weight))                              # fence
    out["merge_ms"] = round((time.perf_counter() - t0) * 1e3, 1)

    # sustained serve-WHILE-streaming (VERDICT r4 #8): integrate windows
    # interleaved with the live incremental mesh + batch ESDF refresh —
    # the MapServer continuous-publish cadence (map_server.cpp:77-152).
    # The one-shot stages above can't catch regressions in the
    # streaming↔serving interaction (round-4's donation/resync bugs
    # lived exactly there); this one drives HostMapper.step_batch →
    # live_mesh (donating, incremental) → ESDF per window and reports
    # the sustained frame rate with serving in the loop.
    mapper = sm.HostMapper(cfg)
    ts_np = np.arange(n, dtype=np.float32) * 0.05
    mapper.step_batch(depths, colors, traj, ts_np)       # warm window
    mapper.live_mesh()                                   # warm mesh path
    lay = sm.get_layer(mapper.state.collection.layers, jnp.asarray(0))
    e = esdf_ops.esdf_from_tsdf(cfg.spec, lay)
    float(jnp.sum(e.dist))
    windows = 3
    tris = 0
    t0 = time.perf_counter()
    for _ in range(windows):
        mapper.step_batch(depths, colors, traj, ts_np)
        v, _ = mapper.live_mesh()            # host soup = inherent fence
        lay = sm.get_layer(mapper.state.collection.layers, jnp.asarray(0))
        e = esdf_ops.esdf_from_tsdf(cfg.spec, lay)
        float(jnp.sum(e.dist))                              # fence
        tris = v.shape[0]
    dt = time.perf_counter() - t0
    out["serve_while_streaming_fps"] = round(n * windows / dt, 1)
    out["serve_live_mesh_tris"] = int(tris)
    return out


# ---------------------------------------------------------------------------
# Solve-side benchmark: two-phase optimize at the reference's Ceres budget
# ---------------------------------------------------------------------------

SOLVE_N = 64
SOLVE_SPACING = 0.8  # m between consecutive submap origins along x


def _wavy_floor_sdf(p):
    """Egg-crate floor whose wavelength (~1.6 m) matches the submap patch
    size so every patch sees full surface curvature (same scene family as
    tests/test_global_opt_scale.py)."""
    import jax.numpy as jnp

    return p[..., 2] - 0.15 * jnp.sin(4.0 * p[..., 0]) \
        - 0.1 * jnp.cos(3.0 * p[..., 1])


def solve_benchmark_problem(n: int = SOLVE_N):
    """64-submap odometry chain over the wavy floor with drift bias —
    ≥100 overlapping pairs. → (init_poses, constraints, layers, spec,
    reg_cfg, solver_cfg, fixed)."""
    import jax.numpy as jnp

    from ..core import geometry as geo, voxel as vx
    from ..ops import registration as reg
    from ..solver import pose_graph as pg

    spec = vx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8, grid_dim=16,
                            max_blocks=64, truncation=0.3)
    reg_cfg = reg.RegistrationConfig(max_points=256, min_weight=0.5)
    rng = np.random.default_rng(7)
    true_poses = np.stack([
        np.asarray(geo.from_xyzyaw(jnp.asarray(
            [k * SOLVE_SPACING, 0.0, 0.0, 0.0]))) for k in range(n)])

    def make_layer(T_world_submap):
        xs, ys, zs = np.arange(-1, 1), np.arange(-2, 2), np.arange(-1, 1)
        coords = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"),
                          axis=-1).reshape(-1, 3).astype(np.int32)
        layer = vx.create_tsdf_layer(spec)
        layer = vx.allocate_blocks(spec, layer, jnp.asarray(coords))
        centers = vx.voxel_centers_of_block(spec, layer.block_coords)
        pw = geo.transform_points(T_world_submap,
                                  centers.reshape(-1, 3)).reshape(
            spec.max_blocks, -1, 3)
        sdf = jnp.clip(_wavy_floor_sdf(pw), -spec.truncation,
                       spec.truncation)
        live = (jnp.arange(spec.max_blocks) < layer.num_blocks)[:, None]
        ramp = jnp.maximum(1.0 - jnp.abs(sdf) / spec.truncation, 0.0)
        weight = jnp.where(live & (jnp.abs(sdf) < spec.truncation),
                           ramp, 0.0)
        return dataclasses.replace(layer, sdf=sdf, weight=weight)

    layers = [make_layer(jnp.asarray(true_poses[k])) for k in range(n)]
    cons = pg.RelPoseConstraints.empty(2 * n)
    init = [true_poses[0]]
    for k in range(n - 1):
        T_rel_true = geo.relative_np(true_poses[k], true_poses[k + 1])
        noise = rng.normal(0, 0.004, 6)
        noise[5] += 0.008  # z drift bias
        T_rel_meas = np.asarray(geo.compose(
            jnp.asarray(T_rel_true),
            geo.se3_exp(jnp.asarray(noise, jnp.float32))))
        cons = cons.add(k, k + 1, jnp.asarray(T_rel_meas),
                        20.0 * jnp.eye(6))
        init.append(np.asarray(geo.compose_np(init[-1], T_rel_meas)))

    fixed = np.zeros((n,), bool)
    fixed[0] = True
    return (jnp.asarray(np.stack(init), jnp.float32), cons, layers, spec,
            reg_cfg, pg.SolverConfig(iterations=10), jnp.asarray(fixed))


def solve_benchmark(reg_iterations: int = 6, repeats: int = 3) -> dict:
    """Warm-then-timed two-phase optimize → {"solve_s" (first timed
    wall), "solve_best_s" (best of ``repeats``), "pairs", "submaps"}.
    The reference's whole-solve Ceres budget is ≤4 s wall
    (pose_graph.h:57-68)."""
    import jax.numpy as jnp

    from ..server import global_opt

    init, cons, layers, spec, reg_cfg, solver_cfg, fixed = \
        solve_benchmark_problem()
    # per-submap surface-point caches AND the stacked-field cache held
    # across calls, as the server holds them across optimizes
    # (ServerSubmap.reg_cache / CoxgraphServer._reg_stack_cache) — the
    # timed call measures steady-state operation
    caches = [None] * len(layers)
    stack_cache: dict = {}

    def solve():
        return global_opt.optimize_two_phase(
            init, cons, spec, layers, reg_cfg=reg_cfg,
            solver_cfg=solver_cfg, registration_weight=30.0,
            reg_iterations=reg_iterations, fixed=fixed,
            reg_caches=caches, stack_cache=stack_cache)

    poses, info = solve()                       # warmup / compile
    float(jnp.sum(poses))                       # readback fence
    walls = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        poses, info = solve()
        float(jnp.sum(poses))
        walls.append(time.perf_counter() - t0)
    return {"solve_s": walls[0], "solve_best_s": min(walls),
            "pairs": int(info["n_registration_pairs"]),
            "submaps": SOLVE_N}
