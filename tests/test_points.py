"""Pointcloud ("merged") integrator — ops/points.py.

Reference parity: the voxblox merged/simple pointcloud-integrator family
(selected per node by the ``method`` param) consumed at tsdf_recover.h:75
(integratePointCloud). Golden strategy (SURVEY.md §4): integrate points
backprojected from an analytic-scene depth render and cross-check the
result against the projective integrator on the SAME frame, plus direct
SDF accuracy at known surface points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from coxgraph_tpu.core import geometry as geo, voxel as vx
from coxgraph_tpu.frontends import synthetic as syn
from coxgraph_tpu.ops import points as pts_ops
from coxgraph_tpu.ops import tsdf as tsdf_ops

SPEC = vx.VoxelGridSpec(voxel_size=0.05, voxels_per_side=8, grid_dim=32,
                        max_blocks=1024, truncation=0.15)
INTR = syn.PinholeIntrinsics().scaled(0.25)     # 160x120


def _frame():
    scene = syn.default_scene()
    T = syn.orbit_trajectory(4, scene.room_center, radius=2.0)[0]
    depth, color = syn.render_depth(scene, INTR, T)
    return scene, T, depth, color


def _cloud_from_depth(depth, color):
    """Backproject a rendered depth image to a sensor-frame cloud."""
    p_cam = tsdf_ops._backproject(INTR, depth)            # (H,W,3)
    pts = np.asarray(p_cam).reshape(-1, 3)
    cols = np.asarray(color).reshape(-1, 3)
    valid = np.asarray(depth).reshape(-1) > 0.1
    return (jnp.asarray(pts), jnp.asarray(cols),
            jnp.asarray(valid))


def test_matches_projective_integrator():
    """The pointcloud path must agree with the projective path on the
    same frame: voxels observed by both carry SDFs within one voxel."""
    scene, T, depth, color = _frame()
    pts, cols, valid = _cloud_from_depth(depth, color)

    proj = tsdf_ops.integrate_frame(
        SPEC, tsdf_ops.TsdfIntegratorConfig(max_touched_blocks=512),
        INTR, vx.create_tsdf_layer(SPEC), depth, color, T)

    cfg = pts_ops.PointIntegratorConfig(max_touched_blocks=512)
    merged = pts_ops.integrate_points(
        SPEC, cfg, vx.create_tsdf_layer(SPEC), pts, cols, valid, T)

    # compare on voxels observed by BOTH paths
    wp = np.asarray(proj.weight)
    wm = np.asarray(merged.weight)
    sp = np.asarray(proj.sdf)
    # align pools via block coords (allocation order may differ)
    idx_p = {tuple(c): i for i, c in enumerate(
        np.asarray(proj.block_coords)[: int(proj.num_blocks)])}
    nm = int(merged.num_blocks)
    assert nm > 10
    sm = np.asarray(merged.sdf)
    n_common = 0
    errs = []
    for j, c in enumerate(np.asarray(merged.block_coords)[:nm]):
        i = idx_p.get(tuple(c))
        if i is None:
            continue
        both = (wp[i] > 1e-6) & (wm[j] > 1e-6)
        n_common += int(both.sum())
        errs.append(np.abs(sp[i][both] - sm[j][both]))
    assert n_common > 5000
    err = np.concatenate(errs)
    # band sampling + bundling quantize the observation set — q90 within
    # one voxel of the dense projective result
    assert np.quantile(err, 0.9) < SPEC.voxel_size, np.quantile(err, 0.9)


def test_surface_accuracy_and_color():
    scene, T, depth, color = _frame()
    pts, cols, valid = _cloud_from_depth(depth, color)
    cfg = pts_ops.PointIntegratorConfig(max_touched_blocks=512)
    layer = pts_ops.integrate_points(
        SPEC, cfg, vx.create_tsdf_layer(SPEC), pts, cols, valid, T)

    # world-frame surface points = the cloud itself; sdf there ≈ 0
    pw = geo.transform_points(T, pts)
    sdf, w, ok = vx.sample_tsdf_trilinear(SPEC, layer, pw)
    ok = np.asarray(ok & valid)
    assert ok.sum() > 1000
    err = np.abs(np.asarray(sdf)[ok])
    assert np.quantile(err, 0.9) < 0.6 * SPEC.voxel_size, \
        np.quantile(err, 0.9)
    # color landed (non-zero where observed)
    assert float(jnp.max(layer.color)) > 0.05


def test_merged_bundles_duplicates():
    """Two coincident points behave as ONE ray with SUMMED weight
    (voxblox merged semantics), not two sequential updates."""
    p = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    T = geo.identity()
    cfg = pts_ops.PointIntegratorConfig(
        max_touched_blocks=64, use_distance_weight=False,
        use_dropoff=False)
    one = pts_ops.integrate_points(
        SPEC, cfg, vx.create_tsdf_layer(SPEC), p, None,
        jnp.ones((1,), bool), T)
    dup = pts_ops.integrate_points(
        SPEC, cfg, vx.create_tsdf_layer(SPEC), jnp.tile(p, (2, 1)), None,
        jnp.ones((2,), bool), T)
    w1 = np.asarray(one.weight)
    w2 = np.asarray(dup.weight)
    assert np.allclose(w2[: int(dup.num_blocks)].sum(),
                       2 * w1[: int(one.num_blocks)].sum(), rtol=1e-5)
    # SDF identical: the merged bundle is the same ray
    s1 = np.sort(np.asarray(one.sdf)[np.asarray(one.weight) > 0])
    s2 = np.sort(np.asarray(dup.sdf)[np.asarray(dup.weight) > 0])
    assert np.allclose(s1, s2, atol=1e-6)


def test_mask_and_range_gating():
    cfg = pts_ops.PointIntegratorConfig(max_touched_blocks=64)
    p = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 50.0]], jnp.float32)
    out = pts_ops.integrate_points(
        SPEC, cfg, vx.create_tsdf_layer(SPEC), p, None,
        jnp.asarray([False, True]), geo.identity())
    # first masked, second out of range → nothing integrated
    assert float(jnp.sum(out.weight)) == 0.0


def test_carving_clears_free_space():
    """carve_samples > 0 writes positive-sdf observations between sensor
    and surface (voxel_carving_enabled parity)."""
    p = jnp.asarray([[0.0, 0.0, 2.0]], jnp.float32)
    T = geo.identity()
    on = pts_ops.integrate_points(
        SPEC, pts_ops.PointIntegratorConfig(
            max_touched_blocks=64, carve_samples=8),
        vx.create_tsdf_layer(SPEC), p, None, jnp.ones((1,), bool), T)
    off = pts_ops.integrate_points(
        SPEC, pts_ops.PointIntegratorConfig(max_touched_blocks=64),
        vx.create_tsdf_layer(SPEC), p, None, jnp.ones((1,), bool), T)
    # free-space voxel halfway down the ray
    q = jnp.asarray([[0.0, 0.0, 1.0]])
    _, w_on, _ = vx.sample_tsdf_trilinear(SPEC, on, q)
    assert int(on.num_blocks) > int(off.num_blocks)
    assert float(w_on[0]) > 0.0
    s_on, _, _ = vx.voxel_lookup(
        SPEC, on, vx.point_to_voxel(SPEC, q[0]))
    assert float(s_on) > 0.5 * SPEC.truncation


def test_stacked_isolation():
    """Integrating into submap 1 of a stack leaves submap 0 untouched."""
    scene, T, depth, color = _frame()
    pts, cols, valid = _cloud_from_depth(depth, color)
    cfg = pts_ops.PointIntegratorConfig(max_touched_blocks=256)
    single = vx.create_tsdf_layer(SPEC)
    stacked = jax.tree.map(lambda x: jnp.stack([x, x]), single)
    out = pts_ops.integrate_points_stacked(
        SPEC, cfg, stacked, jnp.asarray(1, jnp.int32), pts, cols, valid, T)
    assert float(jnp.sum(out.weight[0])) == 0.0
    assert float(jnp.sum(out.weight[1])) > 0.0
    assert int(out.num_blocks[1]) > 0 and int(out.num_blocks[0]) == 0


def test_mapper_pointcloud_pipeline():
    """HostMapper.step_points: cloud-sensor robots run the SAME submap
    pipeline (rollover, history, merged map) as frame sensors — the
    reference client's native pointcloud-topic input (SURVEY.md §3.2)."""
    from coxgraph_tpu.mapper import submap_mapper as sm

    scene = syn.default_scene()
    cfg = sm.MapperConfig(
        spec=SPEC,
        integrator=tsdf_ops.TsdfIntegratorConfig(max_touched_blocks=256),
        intrinsics=INTR, max_submaps=4, max_history=16,
        submap_interval=0.4)
    mapper = sm.HostMapper(cfg)
    traj = syn.orbit_trajectory(8, scene.room_center, radius=2.0)
    for i in range(8):
        depth, color = syn.render_depth(scene, INTR, traj[i])
        pts, cols, valid = _cloud_from_depth(depth, color)
        mapper.step_points(pts, cols, valid, traj[i], 0.2 * i)
    col = mapper.state.collection
    assert int(col.num_submaps) >= 2          # rollovers fired
    assert int(col.hist_count[0]) >= 1        # histories recorded
    # reconstructed surface within a voxel of the analytic scene (q90)
    merged = sm.merged_layer(cfg, col)
    from coxgraph_tpu.ops import mesh as mesh_ops
    verts, _ = mesh_ops.extract_mesh(SPEC, merged, min_weight=1e-4)
    assert verts.shape[0] > 100
    sdf = np.asarray(syn.scene_sdf(scene, jnp.asarray(verts.reshape(-1, 3))))
    assert np.quantile(np.abs(sdf), 0.9) < 1.5 * SPEC.voxel_size


def test_simple_mode_close_to_merged():
    """merge_points=False (the 'simple' variant) lands on the same
    surface; weights differ (no bundling) but geometry agrees."""
    scene, T, depth, color = _frame()
    pts, cols, valid = _cloud_from_depth(depth, color)
    m = pts_ops.integrate_points(
        SPEC, pts_ops.PointIntegratorConfig(max_touched_blocks=512),
        vx.create_tsdf_layer(SPEC), pts, cols, valid, T)
    s = pts_ops.integrate_points(
        SPEC, pts_ops.PointIntegratorConfig(
            max_touched_blocks=512, merge_points=False),
        vx.create_tsdf_layer(SPEC), pts, cols, valid, T)
    pw = geo.transform_points(T, pts)
    for layer in (m, s):
        sdf, _, ok = vx.sample_tsdf_trilinear(SPEC, layer, pw)
        ok = np.asarray(ok & valid)
        assert np.quantile(np.abs(np.asarray(sdf)[ok]), 0.9) \
            < 0.6 * SPEC.voxel_size
