"""End-to-end single-robot demo — SURVEY.md §7's minimum slice
(BASELINE.json config 1→2): synthetic RGB-D clip → submap mapping with
drifting odometry → loop closure → local PGO → merged TSDF → mesh PLY +
TUM trajectory + ATE report.

Run: python examples/single_robot_demo.py [--frames N] [--cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default="/tmp/coxgraph_demo")
    ap.add_argument("--scale", type=float, default=0.25,
                    help="camera resolution scale (1.0 = 640x480)")
    args = ap.parse_args()

    from coxgraph_tpu.utils import runtime
    if args.cpu:
        runtime.force_cpu()
    runtime.enable_compilation_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from coxgraph_tpu.core import geometry as geo, voxel as vx
    from coxgraph_tpu.eval import export, metrics
    from coxgraph_tpu.frontends import synthetic as syn
    from coxgraph_tpu.mapper import submap_mapper as sm
    from coxgraph_tpu.ops import mesh as mesh_ops, tsdf as tsdf_ops
    from coxgraph_tpu.solver import pose_graph as pg

    os.makedirs(args.out, exist_ok=True)
    print(f"backend: {jax.default_backend()}  devices: {jax.devices()}")

    dt = 0.05  # 20 Hz (reference frame-rate assumption, BASELINE.md)
    cfg = sm.MapperConfig(
        spec=vx.VoxelGridSpec(voxel_size=0.05, voxels_per_side=16,
                              grid_dim=64, max_blocks=4096, truncation=0.15),
        integrator=tsdf_ops.TsdfIntegratorConfig(max_touched_blocks=2048),
        intrinsics=syn.PinholeIntrinsics().scaled(args.scale),
        max_submaps=16,
        max_history=256,
        submap_interval=args.frames * dt / 8,  # ~8 submaps per clip
    )
    scene = syn.default_scene()
    traj = syn.orbit_trajectory(args.frames, scene.room_center, radius=2.5)
    odom = syn.noisy_odometry(jax.random.PRNGKey(0), traj,
                              rot_std=0.004, trans_std=0.01)

    # host copies — per-index eager device reads compile per index
    # (utils/hostops)
    traj_np = np.asarray(traj)
    odom_np = np.asarray(odom)
    timers = runtime.Timers()
    mapper = sm.HostMapper(cfg)
    t_start = time.time()
    for i in range(args.frames):
        with timers.scope("render"):
            depth, color = syn.render_depth(scene, cfg.intrinsics,
                                            jnp.asarray(traj_np[i]))
            jax.block_until_ready(depth)
        with timers.scope("mapper_step"):
            mapper.step(depth, color, jnp.asarray(odom_np[i]), i * dt)
            jax.block_until_ready(mapper.state.frame_count)
    state = mapper.state
    wall = time.time() - t_start
    ns = mapper.n_submaps
    print(f"integrated {args.frames} frames → {ns} submaps "
          f"in {wall:.1f}s ({args.frames / wall:.1f} fps)")

    # trajectory before optimization
    stamps, poses_raw = sm.trajectory(state.collection)
    gt_stamps = np.arange(args.frames) * dt
    ate_raw = metrics.ate_rmse(stamps, poses_raw, gt_stamps, np.asarray(traj),
                               align=False)

    # loop closure: ground-truth relative pose between first and last submap
    # (the feature-based path is exercised by two_robot_demo.py)
    start_np = np.asarray(state.collection.start_time)
    frame_of = [int(round(float(start_np[k]) / dt)) for k in range(ns)]
    T_true = np.stack([traj_np[f] for f in frame_of])
    state = sm.add_loop_closure(
        state, 0, ns - 1,
        jnp.asarray(geo.relative_np(T_true[0], T_true[ns - 1])),
        50.0 * jnp.eye(6))
    with timers.scope("local_pgo"):
        state = sm.optimize_local(cfg, state,
                                  pg.SolverConfig(iterations=20))
        jax.block_until_ready(state.collection.T_odom_submap)

    stamps, poses_opt = sm.trajectory(state.collection)
    ate_opt = metrics.ate_rmse(stamps, poses_opt, gt_stamps, np.asarray(traj),
                               align=False)
    print(f"ATE raw odometry: {ate_raw * 100:.2f} cm  "
          f"after loop+PGO: {ate_opt * 100:.2f} cm")

    with timers.scope("merge"):
        merged = sm.merged_layer(cfg, state.collection)
        jax.block_until_ready(merged.sdf)
    with timers.scope("mesh"):
        verts, cols = mesh_ops.extract_mesh(cfg.spec, merged, min_weight=0.1)
    sdf_at_verts = np.abs(np.asarray(
        syn.scene_sdf(scene, jnp.asarray(verts.reshape(-1, 3)))))
    print(f"merged map: {int(merged.num_blocks)} blocks, "
          f"mesh {verts.shape[0]} tris, "
          f"surface err p90 {np.quantile(sdf_at_verts, 0.9) * 100:.2f} cm")

    ply = os.path.join(args.out, "global_mesh.ply")
    export.write_ply(ply, verts, cols)
    export.write_tum_trajectory(os.path.join(args.out, "trajectory.tum"),
                                np.asarray(stamps), np.asarray(poses_opt))
    print(f"wrote {ply} + trajectory.tum")
    print(timers.report())
    ok = ate_opt < max(2.5 * ate_raw, 0.08) and verts.shape[0] > 1000
    print("DEMO", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
