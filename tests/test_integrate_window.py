"""The XLA integration window and its updated-block bookkeeping: a window
is F sequential frame integrations, and the updated bitmap that feeds
MapperState.mesh_dirty names exactly the blocks the frames wrote."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from coxgraph_tpu.core import voxel as vx
from coxgraph_tpu.frontends import synthetic as syn
from coxgraph_tpu.mapper import submap_mapper as sm
from coxgraph_tpu.ops import tsdf as tsdf_ops

SPEC = vx.VoxelGridSpec(voxel_size=0.1, voxels_per_side=8, grid_dim=32,
                        max_blocks=1024, truncation=0.3)
ICFG = tsdf_ops.TsdfIntegratorConfig(max_touched_blocks=512)
INTR = syn.PinholeIntrinsics().scaled(0.125)          # 80x60
S = 2                                                   # stacked submaps
K = 1                                                   # target submap

frame_step = jax.jit(partial(tsdf_ops.integrate_frame_stacked_impl, SPEC,
                             ICFG, INTR, return_stats=True))
window = jax.jit(partial(tsdf_ops.integrate_window_stacked_impl, SPEC, ICFG,
                         INTR, return_stats=True))


def _frames(n):
    scene = syn.default_scene()
    traj = syn.orbit_trajectory(n, scene.room_center, radius=2.5,
                                sweep=0.5 * jnp.pi)
    fr = [syn.render_depth(scene, INTR, traj[i]) for i in range(n)]
    return (jnp.stack([f[0] for f in fr]), jnp.stack([f[1] for f in fr]),
            traj)


def _stacked():
    return jax.tree.map(lambda x: jnp.stack([x] * S),
                        vx.create_tsdf_layer(SPEC))


def test_window_equals_sequential_frames_bit_exact():
    """The window allocates bit-exactly what F single-frame steps
    allocate, and its voxel data passes chip_smoke's layer comparison
    against theirs: XLA compiles the window's loop body differently from
    the single-frame program, so a voxel on a pixel-rounding boundary may
    sample the neighbouring pixel (3 of 85827 at this size)."""
    import chip_smoke as cs

    depths, colors, traj = _frames(4)
    k = jnp.asarray(K, jnp.int32)
    seq = _stacked()
    for i in range(4):
        seq, _ = frame_step(seq, k, depths[i], colors[i], traj[i])
    win, _ = window(_stacked(), k, depths, colors, traj)
    for name in ("block_index", "block_coords", "num_blocks"):
        np.testing.assert_array_equal(np.asarray(getattr(win, name)),
                                      np.asarray(getattr(seq, name)),
                                      err_msg=name)
    assert int(win.num_blocks[K]) > 0 and int(win.num_blocks[0]) == 0
    for name in ("sdf", "weight", "color"):        # submap 0 untouched
        np.testing.assert_array_equal(np.asarray(getattr(win, name))[0],
                                      np.asarray(getattr(seq, name))[0])
    rep = cs.Report()
    cams = np.asarray(traj)
    cs.check_layer_agreement(rep, "window vs frames", cs.layer_agreement(
        SPEC, jax.tree.map(lambda x: x[K], win),
        jax.tree.map(lambda x: x[K], seq),
        lambda c: cs.observation_weights(INTR, cams, c)))
    assert rep.failed == []
    np.testing.assert_allclose(np.asarray(win.color[K]),
                               np.asarray(seq.color[K]), atol=0.25)
    assert (np.asarray(win.color[K]) != np.asarray(seq.color[K])).mean() \
        < 2e-3


def test_window_updated_bitmap_is_union_of_frame_touched_slots():
    depths, colors, traj = _frames(4)
    k = jnp.asarray(K, jnp.int32)
    lay = _stacked()
    union = np.zeros((SPEC.max_blocks,), bool)
    per_frame = []
    for i in range(4):
        lay, upd = frame_step(lay, k, depths[i], colors[i], traj[i])
        per_frame.append(np.asarray(upd))
        union |= per_frame[-1]
    _, updated = window(_stacked(), k, depths, colors, traj)
    np.testing.assert_array_equal(np.asarray(updated), union)
    # the frames see different parts of the room: the union is larger
    # than any one frame's touched set
    assert union.sum() > max(p.sum() for p in per_frame)


def test_single_frame_small_capacity_updates_every_touched_block():
    """max_touched_blocks=64 caps what ONE frame allocates; every block
    the frame allocated receives its update (nothing is dropped between
    allocation and the voxel update)."""
    cfg = tsdf_ops.TsdfIntegratorConfig(max_touched_blocks=64)
    depths, colors, traj = _frames(1)
    step = jax.jit(partial(tsdf_ops.integrate_frame_stacked_impl, SPEC, cfg,
                           INTR, return_stats=True))
    layers, updated = step(_stacked(), jnp.asarray(K, jnp.int32), depths[0],
                           colors[0], traj[0])
    n = int(layers.num_blocks[K])
    assert 0 < n <= 64
    updated = np.asarray(updated)
    np.testing.assert_array_equal(updated, np.arange(SPEC.max_blocks) < n)
    w = np.asarray(layers.weight[K])
    # every allocated block holds observed voxels; no other block does
    assert (w[:n] > 0).any(axis=1).all()
    assert not (w[n:] > 0).any()


def test_step_batch_marks_exactly_the_updated_blocks_dirty():
    cfg = sm.MapperConfig(spec=SPEC, integrator=ICFG, intrinsics=INTR,
                          max_submaps=4, max_history=32,
                          submap_interval=0.3)
    depths, colors, traj = _frames(8)
    hm = sm.HostMapper(cfg)
    # 8 frames at 0.1 s with a 0.3 s interval → submaps at frames 0, 3, 6
    assert hm.step_batch(depths, colors, traj,
                         np.arange(8, dtype=np.float32) * 0.1) == 3
    dirty = np.asarray(hm.state.mesh_dirty)
    nb = np.asarray(hm.state.collection.layers.num_blocks)
    # on a fresh map every allocated block was touched (and updated) by
    # some frame of its submap, and nothing else was
    for k in range(cfg.max_submaps):
        np.testing.assert_array_equal(
            dirty[k], np.arange(SPEC.max_blocks) < nb[k], err_msg=str(k))
    assert nb[:3].min() > 0 and nb[3] == 0
