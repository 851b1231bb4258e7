"""The two-robot collaborative mission — the CVG 2-client experiment
equivalent (BASELINE.json config 4), shared by examples/two_robot_demo.py
and chip_smoke.py.

Two robots with separate drifting odometry frames map overlapping halves
of a synthetic scene through the normal entry points: HostMapper.step_batch
per window of frames, LoopDetector keyframes → MapFusion messages (through
VIOInterface) → CoxgraphServer with InProcessClients (asynchronous
two-phase global optimize) → get_final_global_mesh.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

DT = 0.05           # s between frames (20 Hz per robot)
WINDOW = 4          # frames per step_batch dispatch


def two_robot_mission(n_frames: int = 40, scale: float = 0.25,
                      reg_weight: float = 30.0,
                      out_dir: Optional[str] = None,
                      with_mesh: bool = True) -> dict:
    """Run the mission → metrics dict (fusions, optimize_errors, per-client
    global-frame ATE, client-1 frame alignment error, mesh triangle count
    and surface error quantiles, stream wall). ``scale`` scales the
    640×480 sensor; the submap interval is n_frames·DT/6, so each robot
    starts 6 submaps. ``out_dir`` (optional) receives the PLY mesh and
    TUM trajectories."""
    import jax
    import jax.numpy as jnp

    from ..core import geometry as geo, voxel as vx
    from ..frontends import loop_detector as ld
    from ..frontends import synthetic as syn
    from ..frontends.vio_interface import VIOInterface
    from ..mapper import submap_mapper as sm
    from ..ops import features as ft, tsdf as tsdf_ops
    from ..server import fusion_server as fs
    from ..server.client_interface import InProcessClient
    from . import export, metrics

    n = n_frames
    # pool sizing: per-client device memory = max_submaps × max_blocks ×
    # 80 KB
    spec = vx.VoxelGridSpec(voxel_size=0.05, voxels_per_side=16, grid_dim=64,
                            max_blocks=2048, truncation=0.15)
    cfg = sm.MapperConfig(
        spec=spec,
        integrator=tsdf_ops.TsdfIntegratorConfig(max_touched_blocks=1024),
        intrinsics=syn.PinholeIntrinsics().scaled(scale),
        max_submaps=8, max_history=256,
        submap_interval=n * DT / 6,
    )
    scene = syn.default_scene()
    # two robots, overlapping sweeps, distinct odom frames (yaw+offset)
    trajs = [
        syn.orbit_trajectory(n, scene.room_center, radius=2.4,
                             sweep=1.2 * jnp.pi, start_angle=0.0),
        syn.orbit_trajectory(n, scene.room_center, radius=2.4,
                             sweep=1.2 * jnp.pi, start_angle=jnp.pi),
    ]
    X = [geo.identity(),
         geo.from_xyzyaw(jnp.array([0.8, -0.4, 0.0, 0.5]))]
    odoms = [
        syn.noisy_odometry(jax.random.PRNGKey(r), trajs[r],
                           rot_std=0.002, trans_std=0.005)
        for r in range(2)
    ]
    # host copies: per-index eager device reads would compile a fresh
    # program per index constant (see utils/hostops)
    trajs_np = [np.asarray(t) for t in trajs]
    odoms_np = [np.asarray(o) for o in odoms]
    X_np = [np.asarray(x) for x in X]

    clients = [InProcessClient(r, cfg, sm.create_mapper(cfg))
               for r in range(2)]
    mappers = [sm.HostMapper(cfg, c.state) for c in clients]
    for c, m in zip(clients, mappers):
        c.mapper = m        # timeline/pose lookups from the host mirror
    server = fs.CoxgraphServer(
        fs.ServerConfig(
            spec=spec, max_submaps=48, refuse_interval=0.15,
            registration_weight=reg_weight,
            # the reference's std::async PGO: fusions return immediately
            # and robots keep streaming frames while the solve runs on a
            # background thread (coxgraph_server.cpp:471-473)
            async_pgo=True,
            registration=fs.reg.RegistrationConfig(max_points=1024,
                                                   iterations=10)),
        clients)
    vios = [VIOInterface(r, cfg, clients[r], server) for r in range(2)]
    # the detector decimates frames to its own working width
    # (LoopDetectorConfig.max_width)
    detector = ld.LoopDetector(
        cfg.intrinsics,
        ld.LoopDetectorConfig(
            features=ft.FeatureConfig(max_keypoints=384),
            min_match_score=25, min_inliers=15,
            keyframe_stride=4 * DT, min_time_separation=1e9))

    t0 = time.perf_counter()
    n_fusions = 0
    fusion_dispatch = 0.0       # time the stream thread spent in fusions
    # every MapFusion the server was offered: (from, to, accepted,
    # rotation error rad, translation error m) against ground truth
    fusion_log = []
    for i0 in range(0, n, WINDOW):
        idx = range(i0, min(i0 + WINDOW, n))
        for r in range(2):
            frames = [syn.render_depth(scene, cfg.intrinsics,
                                       jnp.asarray(trajs_np[r][i]))
                      for i in idx]
            T_odom = np.stack([geo.compose_np(geo.inverse_np(X_np[r]),
                                              odoms_np[r][i]) for i in idx])
            with clients[r].lock:
                mappers[r].state = clients[r].state   # server pose pushes
                mappers[r].step_batch(jnp.stack([f[0] for f in frames]),
                                      jnp.stack([f[1] for f in frames]),
                                      T_odom, np.asarray(idx) * DT)
                clients[r].state = mappers[r].state
            vios[r].T_odom_latest = jnp.asarray(T_odom[-1])
            server.time_line_update()
            for i, (depth, color) in zip(idx, frames):
                for mf in detector.add_keyframe(r, i * DT, color, depth):
                    if not vios[r].need_to_fuse(mf.from_client,
                                                mf.to_client, mf.to_time):
                        continue
                    tf0 = time.perf_counter()
                    ok = vios[r].publish_loop_closure(
                        mf.from_client, mf.from_time, mf.to_client,
                        mf.to_time, mf.T_from_to)
                    fusion_dispatch += time.perf_counter() - tf0
                    n_fusions += int(ok)
                    T_true = geo.relative_np(
                        trajs_np[mf.from_client][round(mf.from_time / DT)],
                        trajs_np[mf.to_client][round(mf.to_time / DT)])
                    e = np.asarray(geo.se3_log(jnp.asarray(geo.relative_np(
                        T_true, np.asarray(mf.T_from_to)))))
                    fusion_log.append((mf.from_client, mf.to_client,
                                       bool(ok),
                                       float(np.linalg.norm(e[:3])),
                                       float(np.linalg.norm(e[3:]))))
    server.wait_for_optimize()   # land the last background solve
    out = {
        "frames_per_robot": n,
        "detector_width": detector.det_intr.width,
        "submap_interval_s": cfg.submap_interval,
        "width": cfg.intrinsics.width, "height": cfg.intrinsics.height,
        "stream_wall_s": time.perf_counter() - t0,
        "fusions": n_fusions,
        "server_submaps": len(server.submaps),
        "optimize_errors": list(server.optimize_errors),
        "solve_wall_s": sum(f.get("solve_wall", 0.0)
                            for f in server.fusion_log),
        "fusion_dispatch_s": fusion_dispatch,
        "fusion_log": fusion_log,
    }
    err = geo.se3_log(geo.relative(server.T_G_cli[1], X[1]))
    out["client1_align_rot"] = float(np.linalg.norm(err[:3]))
    out["client1_align_trans"] = float(np.linalg.norm(err[3:]))

    if with_mesh:
        t1 = time.perf_counter()
        _, verts, _ = server.get_final_global_mesh(
            os.path.join(out_dir, "global_mesh.ply") if out_dir else None,
            mesh_spec=vx.VoxelGridSpec(
                voxel_size=spec.voxel_size, voxels_per_side=16, grid_dim=64,
                max_blocks=6144, truncation=spec.truncation))
        out["final_mesh_wall_s"] = time.perf_counter() - t1
        sdf = np.abs(np.asarray(
            syn.scene_sdf(scene, jnp.asarray(verts.reshape(-1, 3)))))
        out["mesh_tris"] = int(verts.shape[0])
        out["surface_err_p50_m"] = float(np.median(sdf)) if sdf.size else 0.0
        out["surface_err_p90_m"] = (float(np.quantile(sdf, 0.9))
                                    if sdf.size else float("inf"))
    else:
        # collect + final optimize without paying for the mesh
        server.collect_all_submaps()
        if len(server.submaps) >= 2:
            server.optimize()

    ates, ates_aligned = [], []
    for r in range(2):
        stamps, poses = server.pose_history(r)
        order = np.argsort(stamps)
        for align, acc in ((False, ates), (True, ates_aligned)):
            acc.append(float(metrics.ate_rmse(
                stamps[order], np.asarray(poses)[order], np.arange(n) * DT,
                trajs_np[r], align=align)))
        if out_dir:
            export.write_tum_trajectory(
                os.path.join(out_dir, f"client{r}.tum"),
                stamps[order], np.asarray(poses)[order])
    out["ate_m"] = ates
    out["ate_aligned_m"] = ates_aligned    # after a best-fit rigid motion
    out["bytes_shipped"] = int(sum(c.bytes_sent for c in clients))
    return out
