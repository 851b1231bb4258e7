"""Projective TSDF integration of RGB-D frames — replaces the voxblox
fast/merged/projective integrators (reference call sites: tsdf_recover.h:75,
tsdf_recover.yaml:5-12, launch/firefly/tsdf_client.launch:25-50).

Accelerator design: instead of per-ray CPU ray-casting with OpenMP
threads (integrator_threads: 8), each frame is integrated in two dense
passes inside one jit:

  1. **Allocation** — backproject a (strided) pixel grid at a few depths
     spanning the truncation band, scatter the touched block coordinates
     into the dense block-index grid, and compact the touched pool slots
     straight out of the allocation bitmap (no re-lookup of the raw,
     duplicate-heavy candidates).
  2. **Update** — for the ≤ max_touched_blocks touched blocks, project all
     16³ voxel centers into the frame at once, gather depths, and apply
     the weighted running-average TSDF update, scattering the touched
     pool rows back. A window of frames (integrate_window_stacked_impl)
     is a scan of exactly these per-frame steps.

The canonical implementation is `integrate_frame_stacked_impl`, which
operates on a stacked submap collection (leading (S,) axis on every leaf)
through a flat (S·max_blocks) pool view so no per-submap copy of the voxel
pools is ever materialized. The single-layer `integrate_frame` wraps it
with S = 1. Everything is fixed-shape; invalid pixels/blocks ride along
masked.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

# opt-in runtime invariant checks (see _alloc_pass)
_DEBUG_UNIQUE_SLOTS = bool(os.environ.get("COXGRAPH_DEBUG_CHECKS"))

from ..core import geometry as geo
from ..core import voxel as vx
from ..frontends.synthetic import PinholeIntrinsics

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class TsdfIntegratorConfig:
    """Static integrator parameters (reference operating points:
    BASELINE.md — max_ray_length_m 10, truncation 0.15, max_weight 1e4)."""

    max_range: float = 10.0
    min_range: float = 0.1
    max_weight: float = 1.0e4
    max_touched_blocks: int = 2048
    alloc_band_samples: int = 3     # depth samples across the trunc band
    alloc_stride: int = 4           # pixel stride of the allocation pass
    #  (a block spans ≥16 voxels ≈ many pixels — ~40 px even at 10 m
    #   range with 5 cm voxels at 640×480 — so strided sampling cannot
    #   miss one and cuts the allocation-pass candidate count stride²×;
    #   the voxblox "fast" integrator makes the same trade with
    #   subsampled rays. The candidate count drives the dedup sorts.
    #   SCALE WITH RESOLUTION: 8 is safe at 640×480 (the bench config
    #   uses it; ≥5 samples per block footprint), but at 80×60 test
    #   scale stride 8 visibly under-allocates — keep 4 as the default.)
    use_dropoff: bool = True        # linear weight drop-off behind surface
    use_distance_weight: bool = True  # 1/z² observation weighting
    update_chunk_blocks: int = 512  # blocks per update dispatch


def _backproject(intr: PinholeIntrinsics, depth: Array) -> Array:
    """Depth (H,W) → camera-frame points (H,W,3) at pixel centers."""
    u = jnp.arange(intr.width, dtype=jnp.float32)
    v = jnp.arange(intr.height, dtype=jnp.float32)
    uu, vv = jnp.meshgrid(u, v)
    x = (uu - intr.cx) / intr.fx * depth
    y = (vv - intr.cy) / intr.fy * depth
    return jnp.stack([x, y, depth], axis=-1)


def decimate(img: Array, st: int) -> Array:
    """Top-left stride-``st`` decimation of the last two dims via
    reshape+static-slice, which XLA lowers to a plain slice rather than
    a strided gather."""
    if st == 1:
        return img
    H, W = img.shape[-2:]
    ph, pw = (-H) % st, (-W) % st
    if ph or pw:
        img = jnp.pad(img, [(0, 0)] * (img.ndim - 2) + [(0, ph), (0, pw)])
    s = img.shape[:-2]
    img = img.reshape(s + ((H + ph) // st, st, (W + pw) // st, st))
    return img[..., :, 0, :, 0]


def color_layout(color: Array, height: int, width: int) -> str:
    """Classify a color image layout against the KNOWN intrinsics:
    'planar' for (3, H, W), 'interleaved' for (H, W, 3). The single
    layout-decision boundary — callers must not sniff shapes themselves
    (a (3, H, 3) planar image with W == 3 is undecidable from the shape
    alone; the intrinsics disambiguate)."""
    if color.shape == (3, height, width):
        return "planar"
    if color.shape == (height, width, 3):
        return "interleaved"
    raise ValueError(
        f"color shape {color.shape} matches neither planar (3, {height}, "
        f"{width}) nor interleaved ({height}, {width}, 3)")


def _alloc_candidates_soa(spec: vx.VoxelGridSpec, cfg: TsdfIntegratorConfig,
                          intr: PinholeIntrinsics, depth: Array,
                          T_sm_cam: Array):
    """Pass-1 candidate block slots, structure-of-arrays form →
    (grid_slots (N,), valid (N,)).

    Every step runs on (B,h,w) component arrays, so the 3-wide
    coordinate axis never becomes a padded minor dimension."""
    st = cfg.alloc_stride
    d_s = decimate(depth, st)
    valid_s = (d_s > cfg.min_range) & (d_s < cfg.max_range)
    ks = jnp.linspace(-spec.truncation, spec.truncation,
                      cfg.alloc_band_samples)
    d_samples = d_s[None] + ks[:, None, None]              # (B,h,w)
    u = (jnp.arange(intr.width, dtype=jnp.float32)[::st]
         - intr.cx) / intr.fx
    v = (jnp.arange(intr.height, dtype=jnp.float32)[::st]
         - intr.cy) / intr.fy
    dx = u[None, None, :] * d_samples
    dy = v[None, :, None] * d_samples
    R = geo.quat_to_matrix(T_sm_cam[:4])
    t = T_sm_cam[4:7]
    px = R[0, 0] * dx + R[0, 1] * dy + R[0, 2] * d_samples + t[0]
    py = R[1, 0] * dx + R[1, 1] * dy + R[1, 2] * d_samples + t[1]
    pz = R[2, 0] * dx + R[2, 1] * dy + R[2, 2] * d_samples + t[2]
    inv = 1.0 / spec.voxel_size
    vps = spec.voxels_per_side
    bx = jnp.floor_divide(jnp.floor(px * inv).astype(jnp.int32), vps)
    by = jnp.floor_divide(jnp.floor(py * inv).astype(jnp.int32), vps)
    bz = jnp.floor_divide(jnp.floor(pz * inv).astype(jnp.int32), vps)
    h = spec.half_grid
    gd = spec.grid_dim
    in_grid = ((bx >= -h) & (bx < h) & (by >= -h) & (by < h)
               & (bz >= -h) & (bz < h))
    gx = jnp.clip(bx + h, 0, gd - 1)
    gy = jnp.clip(by + h, 0, gd - 1)
    gz = jnp.clip(bz + h, 0, gd - 1)
    grid_slots = (gx * gd + gy) * gd + gz
    valid = (valid_s[None] & (d_samples > cfg.min_range) & in_grid)
    return grid_slots.reshape(-1), valid.reshape(-1)


def touched_block_slots(spec: vx.VoxelGridSpec, layer: vx.TsdfLayer,
                        block_coords: Array, valid: Array,
                        max_touched: int) -> Tuple[Array, Array]:
    """Dedupe candidate block coords → (slots (K,), mask (K,)) pool slots.

    Fixed capacity K = max_touched; extra blocks (beyond capacity) are
    dropped for this call and picked up on later calls. (Used by the
    transform-merge op; the frame integrator compacts its touched set
    straight out of the allocation bitmap instead.)"""
    max_touched = min(max_touched, layer.max_blocks)
    idx = vx.lookup_block(spec, layer, block_coords)
    ok = valid & (idx >= 0)
    touched = jnp.zeros((layer.max_blocks,), dtype=jnp.bool_)
    touched = touched.at[jnp.where(ok, idx, layer.max_blocks)].set(
        True, mode="drop")
    pos = jnp.cumsum(touched.astype(jnp.int32)) - 1
    tgt = jnp.where(touched & (pos < max_touched), pos, max_touched)
    slots = jnp.full((max_touched,), layer.max_blocks, jnp.int32)
    slots = slots.at[tgt].set(jnp.arange(layer.max_blocks, dtype=jnp.int32),
                              mode="drop")
    mask = slots < layer.max_blocks
    slots = jnp.minimum(slots, layer.max_blocks - 1)
    return slots, mask


def integrate_frame_stacked_impl(spec: vx.VoxelGridSpec,
                                 cfg: TsdfIntegratorConfig,
                                 intr: PinholeIntrinsics,
                                 layers: vx.TsdfLayer, k: Array,
                                 depth: Array, color: Optional[Array],
                                 T_sm_cam: Array,
                                 return_stats: bool = False):
    """integrate one RGB-D frame into submap ``k`` of a STACKED collection
    (every TsdfLayer leaf carries a leading (S,) submap axis) without ever
    materializing a per-submap copy of the voxel pools.

    The naive route — dynamic-index submap k out, integrate, write it
    back — copies the full (max_blocks, v³) sdf/weight/color pools twice
    per frame (~1 GB of device-memory traffic at reference scale). Here the big
    pools are addressed through a flat (S·max_blocks) view with base
    offset k·max_blocks: every access stays a gather/scatter of just the
    touched blocks. Only the SMALL per-submap arrays (block_index 1 MB,
    block_coords, num_blocks) are sliced out and written back.

    depth: (H,W) z-depth (0 = invalid); color: (H,W,3) in [0,1] or None;
    T_sm_cam: (7,) camera pose in the submap frame; k: () int32.
    """
    layers, touched = _frame_step(spec, cfg, intr, layers, k, depth, color,
                                  T_sm_cam)
    return (layers, touched) if return_stats else layers


def _frame_step(spec, cfg, intr, layers, k, depth, color, T_sm_cam):
    """Both passes for one frame → (layers', updated (max_blocks,) bool).

    ``updated`` marks the pool slots whose voxel data this frame wrote —
    the voxblox per-block updated(mesh) flag the reference MeshIntegrator
    consumes (map_server.cpp:119-152); it feeds MapperState.mesh_dirty."""
    mb = spec.max_blocks
    layers, slots, slot_mask, bc_k = _alloc_pass(spec, cfg, intr, layers,
                                                 k, depth, T_sm_cam)
    updated = jnp.zeros((mb,), jnp.bool_).at[
        jnp.where(slot_mask, slots, mb)].set(True, mode="drop")
    layers = _update_pass(spec, cfg, intr, layers, k * mb, bc_k, slots,
                          slot_mask, depth, color, geo.inverse(T_sm_cam))
    return layers, updated


def _alloc_pass(spec: vx.VoxelGridSpec, cfg: TsdfIntegratorConfig,
                intr: PinholeIntrinsics, layers: vx.TsdfLayer, k: Array,
                depth: Array, T_sm_cam: Array):
    """Pass 1 for one frame on the stacked collection: allocate the
    blocks the frame's truncation band touches and compact the touched
    slots. → (layers', slots (K,) clamped, slot_mask (K,), bc_k (mb,3))."""
    mb = spec.max_blocks
    g3 = spec.grid_dim ** 3

    grid_slots, cand_valid = _alloc_candidates_soa(spec, cfg, intr, depth,
                                                   T_sm_cam)
    K = min(cfg.max_touched_blocks, mb)
    bi_k, bc_k, nb_k, slots, slot_mask = vx.allocate_and_slots(
        spec, layers.block_index[k].reshape(g3), layers.block_coords[k],
        layers.num_blocks[k], grid_slots, cand_valid, K)
    layers = dataclasses.replace(
        layers,
        block_index=layers.block_index.at[k].set(
            bi_k.reshape(layers.block_index.shape[1:])),
        block_coords=layers.block_coords.at[k].set(bc_k),
        num_blocks=layers.num_blocks.at[k].set(nb_k),
    )
    slots = jnp.minimum(slots, mb - 1)  # safe gather addresses (masked)

    if _DEBUG_UNIQUE_SLOTS:
        # opt-in guard (COXGRAPH_DEBUG_CHECKS=1) for the allocate_and_slots
        # uniqueness postcondition the pool scatters' unique_indices hint
        # depends on (duplicates under the hint = silent pool corruption)
        def _assert_unique(s, m):
            import numpy as _np
            live = _np.asarray(s)[_np.asarray(m)]
            if len(_np.unique(live)) != len(live):
                raise AssertionError(
                    "allocate_and_slots returned duplicate mask-True slots")
        jax.debug.callback(_assert_unique, slots, slot_mask)
    return layers, slots, slot_mask, bc_k


def integrate_window_stacked_impl(spec: vx.VoxelGridSpec,
                                  cfg: TsdfIntegratorConfig,
                                  intr: PinholeIntrinsics,
                                  layers: vx.TsdfLayer, k: Array,
                                  depths: Array, colors: Optional[Array],
                                  T_sm_cams: Array,
                                  return_stats: bool = False):
    """Integrate a WINDOW of F frames into submap ``k`` of a stacked
    collection: a loop of F integrate_frame_stacked_impl steps. The
    allocation is identical; the voxel data is up to voxels on
    pixel-rounding boundaries, which may sample the neighbouring pixel
    (XLA compiles a loop body differently from the single-frame program:
    fused multiply-adds land elsewhere). colors: (F,H,W,3) | (F,3,H,W) |
    None.

    ``return_stats=True`` additionally returns the (max_blocks,) bool
    bitmap of pool slots whose voxel data this window updated (the union
    of the frames' ``updated`` bitmaps, see _frame_step)."""

    def body(i, carry):
        lay, updated = carry
        c = None if colors is None else colors[i]
        lay, upd = _frame_step(spec, cfg, intr, lay, k, depths[i], c,
                               T_sm_cams[i])
        return lay, updated | upd

    layers, updated = jax.lax.fori_loop(
        0, depths.shape[0], body,
        (layers, jnp.zeros((spec.max_blocks,), jnp.bool_)))
    return (layers, updated) if return_stats else layers


def _update_pass(spec, cfg, intr, layers, base, bc_k, slots, slot_mask,
                 depth, color, T_cam_sm):
    """Pass 2 for one frame: the weighted running-average voxel update of
    the touched blocks, read from and scattered back into the flat
    (S·max_blocks) pools at offset ``base``."""
    S = layers.sdf.shape[0]
    mb = spec.max_blocks
    v = spec.voxels_per_side
    K = slots.shape[0]
    depth_flat = depth.reshape(-1)
    # color may arrive interleaved (H,W,3) or planar (3,H,W); the layout
    # decision lives in color_layout (intrinsics-driven, no shape sniff)
    if color is None:
        color_flat = None
    elif color_layout(color, intr.height, intr.width) == "planar":
        color_flat = color.reshape(3, -1).T
    else:
        color_flat = color.reshape(-1, 3)
    tau = spec.truncation
    npix = intr.height * intr.width
    # pools ride the scan FLAT (N, v³), the layout they are stored in
    # (core/voxel.py); reshape only the gathered rows
    v3 = v ** 3
    sdf_pool0 = layers.sdf.reshape(S * mb, v3)
    w_pool0 = layers.weight.reshape(S * mb, v3)
    c_pool0 = layers.color.reshape(S * mb, v3 * 3)

    def update_chunk(carry, chunk):
        sdf_pool, w_pool, c_pool = carry
        c_slots, c_mask = chunk
        # unique scatter targets: masked rows get
        # distinct out-of-range ids so the unique_indices hint holds
        flat_slots = jnp.where(
            c_mask, base + c_slots,
            S * mb + jnp.arange(c_slots.shape[0], dtype=jnp.int32))
        coords = bc_k[c_slots]                                 # (C,3)
        centers = vx.voxel_centers_of_block(spec, coords)
        p_cam = geo.transform_points(T_cam_sm, centers)
        z = p_cam[..., 2]
        u = p_cam[..., 0] / jnp.maximum(z, 1e-6) * intr.fx + intr.cx
        vv = p_cam[..., 1] / jnp.maximum(z, 1e-6) * intr.fy + intr.cy
        ui = jnp.round(u).astype(jnp.int32)
        vi = jnp.round(vv).astype(jnp.int32)
        in_img = (
            (z > cfg.min_range)
            & (ui >= 0) & (ui < intr.width)
            & (vi >= 0) & (vi < intr.height)
        )
        # spread dummy addresses for masked voxels, so masked lanes do
        # not all read the same address
        lin = (vi * intr.width + ui).reshape(-1)
        spread = jax.lax.broadcasted_iota(
            jnp.int32, (lin.shape[0], 1), 0).squeeze(-1) % npix
        lin = jnp.where(in_img.reshape(-1), lin, spread)
        d = depth_flat[lin].reshape(in_img.shape)
        has_depth = in_img & (d > cfg.min_range) & (d < cfg.max_range)

        sdf = d - z
        observed = has_depth & (sdf > -tau)
        w_obs = jnp.ones_like(sdf)
        if cfg.use_distance_weight:
            w_obs = w_obs / jnp.maximum(d * d, 1.0)
        if cfg.use_dropoff:
            # 1 in front of surface, linearly → 0 from -τ/2 to -τ behind
            dropoff = jnp.clip((sdf + tau) / (0.5 * tau), 0.0, 1.0)
            w_obs = w_obs * dropoff
        w_obs = jnp.where(observed & c_mask[:, None, None, None], w_obs, 0.0)
        sdf_obs = jnp.clip(sdf, -tau, tau)

        vshape = in_img.shape                   # (C, v, v, v)
        C = vshape[0]
        safe = jnp.minimum(flat_slots, S * mb - 1)
        old_sdf = sdf_pool[safe].reshape(vshape)
        old_w = w_pool[safe].reshape(vshape)
        new_w = jnp.minimum(old_w + w_obs, cfg.max_weight)
        new_sdf = jnp.where(
            new_w > 0,
            (old_w * old_sdf + w_obs * sdf_obs) / jnp.maximum(new_w, 1e-9),
            old_sdf,
        )
        sdf_pool = sdf_pool.at[flat_slots].set(new_sdf.reshape(C, -1),
                                               mode="drop",
                                               unique_indices=True)
        w_pool = w_pool.at[flat_slots].set(new_w.reshape(C, -1),
                                           mode="drop",
                                           unique_indices=True)

        if color_flat is not None:
            # image gather stays interleaved (the image is (H,W,3)); the
            # pool is planar — move channels up front (small, K rows)
            c_img = jnp.moveaxis(color_flat[lin].reshape(vshape + (3,)),
                                 -1, 1)                      # (C,3,v,v,v)
            near_surface = w_obs * (jnp.abs(sdf) < tau)
            old_c = c_pool[safe].reshape((C, 3) + vshape[1:])
            new_c = jnp.where(
                (new_w > 0)[:, None],
                (old_w[:, None] * old_c + near_surface[:, None] * c_img)
                / jnp.maximum(new_w, 1e-9)[:, None],
                old_c,
            )
            c_pool = c_pool.at[flat_slots].set(new_c.reshape(C, -1),
                                               mode="drop",
                                               unique_indices=True)
        return (sdf_pool, w_pool, c_pool), None

    chunk = min(cfg.update_chunk_blocks, K)
    n_chunks = -(-K // chunk)
    if n_chunks == 1:
        # no scan: a length-1 scan still copies the (large) pool carries
        (sdf_out, w_out, c_out), _ = update_chunk(
            (sdf_pool0, w_pool0, c_pool0), (slots, slot_mask))
    else:
        pad = n_chunks * chunk - K
        # pad masks OFF (padded slots would race duplicate writes)
        slots_p = jnp.pad(slots, (0, pad)).reshape(n_chunks, chunk)
        mask_p = jnp.pad(slot_mask, (0, pad)).reshape(n_chunks, chunk)
        (sdf_out, w_out, c_out), _ = jax.lax.scan(
            update_chunk, (sdf_pool0, w_pool0, c_pool0), (slots_p, mask_p))

    return dataclasses.replace(
        layers,
        sdf=sdf_out.reshape(layers.sdf.shape),
        weight=w_out.reshape(layers.weight.shape),
        color=c_out.reshape(layers.color.shape),
    )


integrate_frame_stacked = partial(jax.jit, static_argnums=(0, 1, 2),
                                  donate_argnums=3)(
    integrate_frame_stacked_impl
)
integrate_frame_stacked.__doc__ = "Jitted integrate_frame_stacked_impl."


def integrate_frame_impl(spec: vx.VoxelGridSpec, cfg: TsdfIntegratorConfig,
                         intr: PinholeIntrinsics, layer: vx.TsdfLayer,
                         depth: Array, color: Optional[Array],
                         T_sm_cam: Array) -> vx.TsdfLayer:
    """Unjitted single-layer integrate (S = 1 view of the stacked impl;
    for vmap/shard_map composition).

    depth: (H,W) z-depth (0 = invalid); color: (H,W,3) in [0,1] or None;
    T_sm_cam: (7,) camera pose in the layer (submap) frame.
    """
    stacked = jax.tree.map(lambda x: x[None], layer)
    out = integrate_frame_stacked_impl(
        spec, cfg, intr, stacked, jnp.zeros((), jnp.int32), depth, color,
        T_sm_cam)
    return jax.tree.map(lambda x: x[0], out)


integrate_frame = partial(jax.jit, static_argnums=(0, 1, 2))(
    integrate_frame_impl)
integrate_frame.__doc__ = "Jitted integrate_frame_impl."
