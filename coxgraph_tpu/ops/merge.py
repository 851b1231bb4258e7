"""Transform-and-fuse of TSDF layers — replaces voxblox
``mergeLayerAintoLayerB`` (reference call sites: submap_collection.cpp:31-33
server-side client-map reassembly; map_server.cpp:66-70 client merged-map
rebuild; msg_converter.h:48-50).

Accelerator design: resampling, not voxel-list iteration. Destination voxel centers
of every touched block are transformed into the source frame and the source
TSDF is sampled trilinearly; weighted running averages fuse the result into
the destination pool. Source blocks conservatively allocate a 3³
neighborhood of destination blocks around their transformed AABB (a block's
rotated bounding box spans ≤ 3 destination blocks per axis), all as fixed-
shape scatters.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..core import geometry as geo
from ..core import voxel as vx
from .tsdf import touched_block_slots

Array = jax.Array


def _candidate_dst_blocks(dst_spec: vx.VoxelGridSpec,
                          src_spec: vx.VoxelGridSpec, src: vx.TsdfLayer,
                          T_dst_src: Array):
    """→ (coords (S*n³, 3) int32, valid (S*n³,) bool): destination block
    coordinates conservatively covering each live source block. n per axis
    is derived from the block-size ratio so cross-resolution merges
    (server 0.05 m vs client 0.10 m voxels, coxgraph_server.launch:5-6 vs
    coxgraph_client.yaml) stay covered: a rotated source block's AABB
    spans ≤ src_block·√3, hence ≤ floor(src_block·√3/dst_block)+2
    destination blocks per axis (= 3 in the same-spec case)."""
    s_src, s_dst = src_spec.block_size, dst_spec.block_size
    n_off = int(s_src * (3.0 ** 0.5) / s_dst) + 2
    live = jnp.arange(src.max_blocks) < src.num_blocks
    origin = vx.block_origin(src_spec, src.block_coords)      # (S,3)
    corners = jnp.stack(
        jnp.meshgrid(*([jnp.array([0.0, 1.0])] * 3), indexing="ij"), axis=-1
    ).reshape(8, 3) * s_src                                    # (8,3)
    pts = origin[:, None, :] + corners[None, :, :]             # (S,8,3)
    pts_dst = geo.transform_points(T_dst_src, pts)
    bmin = jnp.floor(jnp.min(pts_dst, axis=1) / s_dst).astype(jnp.int32)
    offs = jnp.stack(
        jnp.meshgrid(*([jnp.arange(n_off)] * 3), indexing="ij"), axis=-1
    ).reshape(-1, 3).astype(jnp.int32)
    cand = bmin[:, None, :] + offs[None, :, :]                 # (S,n³,3)
    valid = jnp.broadcast_to(live[:, None], cand.shape[:2])
    return cand.reshape(-1, 3), valid.reshape(-1)


def _packed_trilinear(spec: vx.VoxelGridSpec, layer: vx.TsdfLayer,
                      packed: Array, p: Array):
    """sample_tsdf_trilinear against a (sdf,weight)-packed u32 pool —
    half the gather count of the separate-pool sampler (merge-only; the
    registration path keeps the exact f32 sampler)."""
    x = p / spec.voxel_size - 0.5
    v0 = jnp.floor(x).astype(jnp.int32)
    frac = x - v0.astype(x.dtype)
    vps = spec.voxels_per_side
    v3 = vps * vps * vps
    total = layer.sdf.shape[0] * v3
    n = 1
    for d in p.shape[:-1]:
        n *= d
    spread = jax.lax.broadcasted_iota(
        jnp.int32, (n, 1), 0).squeeze(-1).reshape(p.shape[:-1]) % total
    sdf_acc = jnp.zeros(p.shape[:-1], jnp.float32)
    w_acc = jnp.zeros_like(sdf_acc)
    valid = jnp.ones(p.shape[:-1], jnp.bool_)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                corner = v0 + jnp.array([dx, dy, dz], jnp.int32)
                b, l = vx.voxel_to_block(spec, corner)
                idx = vx.lookup_block(spec, layer, b)
                lin = (l[..., 0] * vps + l[..., 1]) * vps + l[..., 2]
                ok_b = idx >= 0
                flat = jnp.where(ok_b, idx * v3 + lin, spread)
                u = packed[flat]
                s = jax.lax.bitcast_convert_type(
                    (u >> 16).astype(jnp.uint16),
                    jnp.bfloat16).astype(jnp.float32)
                w = jax.lax.bitcast_convert_type(
                    (u & 0xFFFF).astype(jnp.uint16),
                    jnp.bfloat16).astype(jnp.float32)
                wt = ((frac[..., 0] if dx else 1 - frac[..., 0])
                      * (frac[..., 1] if dy else 1 - frac[..., 1])
                      * (frac[..., 2] if dz else 1 - frac[..., 2]))
                sdf_acc = sdf_acc + wt * s
                w_acc = w_acc + wt * w
                valid = valid & ok_b & (w > 0)
    return (jnp.where(valid, sdf_acc, spec.truncation),
            jnp.where(valid, w_acc, 0.0), valid)


@partial(jax.jit, static_argnums=(0, 2))
def count_touched_dst_blocks(dst_spec: vx.VoxelGridSpec,
                             src: vx.TsdfLayer,
                             src_spec: vx.VoxelGridSpec,
                             T_dst_src: Array) -> Array:
    """() int32 — how many DISTINCT destination blocks this merge's
    candidate set covers (grid-bitmap dedup of _candidate_dst_blocks).
    One tiny dispatch; merge_layer_into_sized uses the host readback to
    bucket max_touched to the actual need — the merge's trilinear
    gathers scale with max_touched·v³ whether the rows are live or
    padding (identical result)."""
    cand, valid = _candidate_dst_blocks(dst_spec, src_spec, src, T_dst_src)
    g3 = dst_spec.grid_dim ** 3
    slot = vx.block_grid_slot(dst_spec, cand)
    ok = valid & vx.block_in_grid(dst_spec, cand)
    bm = jnp.zeros((g3,), jnp.bool_).at[
        jnp.where(ok, slot, g3)].set(True, mode="drop")
    return jnp.sum(bm.astype(jnp.int32))


def merge_layer_into_sized(spec: vx.VoxelGridSpec, dst: vx.TsdfLayer,
                           src: vx.TsdfLayer, T_dst_src: Array,
                           src_spec: vx.VoxelGridSpec = None,
                           min_bucket: int = 256) -> vx.TsdfLayer:
    """merge_layer_into with max_touched auto-bucketed (next power of
    two over the counted candidate cover, floor ``min_bucket``) — the
    control-rate merge entry point for host loops (final global mesh,
    merged client maps). Costs one extra scalar readback per merge and
    cuts the dominant gather work ~linearly with the padding removed."""
    import numpy as np

    n = int(np.asarray(count_touched_dst_blocks(
        spec, src, src_spec or spec, T_dst_src)))
    mt = max(min_bucket, 1 << max(n - 1, 1).bit_length())
    mt = min(mt, dst.max_blocks)
    return merge_layer_into(spec, dst, src, T_dst_src, mt, src_spec)


@partial(jax.jit, static_argnums=(0, 4, 5), donate_argnums=1)
def merge_layer_into(spec: vx.VoxelGridSpec, dst: vx.TsdfLayer,
                     src: vx.TsdfLayer, T_dst_src: Array,
                     max_touched: int = 4096,
                     src_spec: vx.VoxelGridSpec = None) -> vx.TsdfLayer:
    """Fuse src (posed by T_dst_src) into dst. Returns updated dst.
    ``src_spec`` (default: same as dst) enables cross-resolution fusion —
    the destination is resampled from the source at its own grid, the
    reference's mergeLayerAintoLayerB between the server's finer mesh
    layer and client-resolution submaps."""
    src_spec = src_spec or spec
    cand, cand_valid = _candidate_dst_blocks(spec, src_spec, src, T_dst_src)
    dst = vx.allocate_blocks(spec, dst, cand, cand_valid)

    slots, slot_mask = touched_block_slots(spec, dst, cand, cand_valid,
                                           max_touched)
    K = slots.shape[0]
    # (sdf, weight) packed as two bf16 in one u32 so the trilinear
    # corner fetch is 8 gathers instead of 16 — the merge's cost is its
    # gathers, and bf16 sdf error (≤0.4 % of truncation) is far below
    # voxel scale. One full-pool pack pass.
    s16 = jax.lax.bitcast_convert_type(
        src.sdf.astype(jnp.bfloat16), jnp.uint16).astype(jnp.uint32)
    w16 = jax.lax.bitcast_convert_type(
        src.weight.astype(jnp.bfloat16), jnp.uint16).astype(jnp.uint32)
    packed = ((s16 << 16) | w16).reshape(-1)               # (S·v³,)
    # spread DEAD rows across distinct pool rows / block coords: clamped
    # duplicates made every masked row sample and write the same
    # addresses — duplicate-address gathers/scatters serialize
    ridx = jnp.arange(K, dtype=jnp.int32)
    slots = jnp.where(slot_mask, slots, ridx % dst.sdf.shape[0])
    gd = spec.grid_dim
    h = spec.half_grid
    spread_c = jnp.stack([ridx % gd, (ridx // gd) % gd,
                          (ridx // (gd * gd)) % gd], axis=-1) - h
    coords = jnp.where(slot_mask[:, None], dst.block_coords[slots],
                       spread_c)
    centers = vx.voxel_centers_of_block(spec, coords)          # (K,v,v,v,3)
    p_src = geo.transform_points(geo.inverse(T_dst_src), centers)
    s_sdf, s_w, s_ok = _packed_trilinear(src_spec, src, packed, p_src)
    # nearest-voxel color from source (flat planar pool rows: per-channel
    # gather via a broadcast channel offset on the linear voxel index)
    v3 = spec.voxels_per_side ** 3                 # dst voxels per block
    sv = src_spec.voxels_per_side
    sv3 = sv * sv * sv
    K = slots.shape[0]
    vsrc = vx.point_to_voxel(src_spec, p_src)
    b, l = vx.voxel_to_block(src_spec, vsrc)
    bidx = vx.lookup_block(src_spec, src, b)
    lin = ((l[..., 0] * sv + l[..., 1]) * sv + l[..., 2]).reshape(K, 1, v3)
    ch_off = (jnp.arange(3) * sv3).reshape(1, 3, 1)
    # spread dummy rows for unallocated source blocks (same
    # duplicate-gather rule as above); their colors are masked by w_in=0
    bflat = bidx.reshape(K, 1, v3)
    spread_b = (jax.lax.broadcasted_iota(jnp.int32, (K, 1, v3), 0) * v3
                + jax.lax.broadcasted_iota(jnp.int32, (K, 1, v3), 2)
                ) % src.sdf.shape[0]
    brow = jnp.where(bflat >= 0, bflat, spread_b)
    c_src = src.color[brow, ch_off + lin]                  # (K,3,v³)

    s_sdf = s_sdf.reshape(K, v3)
    w_in = jnp.where((s_ok & slot_mask[:, None, None, None]).reshape(K, v3),
                     s_w.reshape(K, v3), 0.0)
    old_sdf = dst.sdf[slots]                               # (K,v³)
    old_w = dst.weight[slots]
    old_c = dst.color[slots].reshape(K, 3, v3)
    new_w = old_w + w_in
    new_sdf = jnp.where(
        new_w > 0,
        (old_w * old_sdf + w_in * s_sdf) / jnp.maximum(new_w, 1e-9),
        old_sdf,
    )
    new_c = jnp.where(
        (new_w > 0)[:, None],
        (old_w[:, None] * old_c + w_in[:, None] * c_src)
        / jnp.maximum(new_w, 1e-9)[:, None],
        old_c,
    ).reshape(K, 3 * v3)
    # dead rows scatter to distinct OUT-OF-RANGE targets (dropped): a
    # spread dead row may alias a live row's slot, and a clamped
    # duplicate target both serializes the scatter and races the live
    # write
    tgt = jnp.where(slot_mask, slots, dst.sdf.shape[0] + ridx)
    return dataclasses.replace(
        dst,
        sdf=dst.sdf.at[tgt].set(new_sdf, mode="drop",
                                unique_indices=True),
        weight=dst.weight.at[tgt].set(new_w, mode="drop",
                                      unique_indices=True),
        color=dst.color.at[tgt].set(new_c, mode="drop",
                                    unique_indices=True),
    )
