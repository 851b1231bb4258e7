"""Block-sparse TSDF/ESDF voxel storage — replaces voxblox Layer/Block.

The reference stores voxels in hash-indexed 16³ blocks
(voxblox ``Layer<TsdfVoxel>``; used at e.g. map_server.h:88-94,
msg_converter.h:48-50). A CPU hash map does not jit, so the accelerator design is:

  * a fixed-capacity **block pool**: dense FLAT arrays ``(max_blocks,
    vps³)`` for sdf / weight (color: ``(max_blocks, 3·vps³)`` planar) —
    scatter-updated in place under jit; flat rows keep XLA's tiled
    layouts copy-free on every jit/scan boundary (see TsdfLayer);
  * a dense **block index grid** ``(G, G, G) int32`` mapping quantized block
    coordinates to pool slots (-1 = unallocated). With 16-voxel blocks at
    0.05–0.10 m voxels a 64³ grid spans 51–102 m — ample for the reference's
    scenes — and costs only 1 MiB, turning every hash lookup into a single
    gather and every allocation into a scatter + prefix-sum. This is the
    jit-friendly replacement for voxblox's AnyIndexHashMapType.

Block coordinates are centered: valid range is [-G/2, G/2). Everything is a
pytree of arrays; all ops are pure functions usable inside jit/vmap/shard_map.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class VoxelGridSpec:
    """Static geometry of a voxel layer (hashable; passed as static arg)."""

    voxel_size: float = 0.05          # m (reference: coxgraph_server.launch:5)
    voxels_per_side: int = 16          # reference: mav_...two.launch:8
    grid_dim: int = 64                 # block index grid extent per axis
    max_blocks: int = 8192             # block pool capacity
    truncation: float = 0.15           # m (reference: coxgraph_server.launch:6)

    def __post_init__(self):
        assert self.grid_dim % 2 == 0

    @property
    def block_size(self) -> float:
        return self.voxel_size * self.voxels_per_side

    @property
    def half_grid(self) -> int:
        return self.grid_dim // 2


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TsdfLayer:
    """Block-sparse TSDF volume (pytree of arrays).

    sdf/weight: (max_blocks, vps³) f32, FLAT voxel rows in C-order
    (ix·vps² + iy·vps + iz). color: (max_blocks, 3·vps³) f32 in [0,1],
    channel-PLANAR rows [r(vps³), g, b]. The pools are stored flat because
    every consumer (integrator, mesher, ESDF, merge) addresses whole
    voxel rows: one layout for all of them means no full-pool relayout
    copy at a jit or scan boundary.
    Spatially-indexed consumers (mesher, ESDF, merge) reshape gathered
    rows or whole pools to (.., vps, vps, vps) views locally at
    control rate.
    block_index: (G,G,G) int32 pool slot or -1.
    block_coords: (max_blocks, 3) int32 quantized block coordinate per slot.
    num_blocks: () int32 — pool watermark (slots [0, num_blocks) are live).
    """

    sdf: Array
    weight: Array
    color: Array
    block_index: Array
    block_coords: Array
    num_blocks: Array

    @property
    def max_blocks(self) -> int:
        return self.sdf.shape[0]

    @property
    def voxels_per_side(self) -> int:
        return round(self.sdf.shape[1] ** (1.0 / 3.0))


def create_tsdf_layer(spec: VoxelGridSpec, dtype=jnp.float32) -> TsdfLayer:
    mb, v, g = spec.max_blocks, spec.voxels_per_side, spec.grid_dim
    return TsdfLayer(
        sdf=jnp.full((mb, v * v * v), spec.truncation, dtype=dtype),
        weight=jnp.zeros((mb, v * v * v), dtype=dtype),
        color=jnp.zeros((mb, 3 * v * v * v), dtype=dtype),
        block_index=jnp.full((g, g, g), -1, dtype=jnp.int32),
        block_coords=jnp.zeros((mb, 3), dtype=jnp.int32),
        num_blocks=jnp.zeros((), dtype=jnp.int32),
    )


# ---------------------------------------------------------------------------
# Coordinate transforms
# ---------------------------------------------------------------------------


def point_to_voxel(spec: VoxelGridSpec, p: Array) -> Array:
    """World point (...,3) → global voxel index (...,3) int32 (floor)."""
    return jnp.floor(p / spec.voxel_size).astype(jnp.int32)


def voxel_to_block(spec: VoxelGridSpec, v: Array):
    """Global voxel index → (block coord, local voxel index), both int32."""
    b = jnp.floor_divide(v, spec.voxels_per_side)
    l = v - b * spec.voxels_per_side
    return b, l


def block_in_grid(spec: VoxelGridSpec, b: Array) -> Array:
    """Mask (...,) — block coordinate falls inside the index grid."""
    h = spec.half_grid
    return jnp.all((b >= -h) & (b < h), axis=-1)


def block_grid_slot(spec: VoxelGridSpec, b: Array) -> Array:
    """Block coordinate (...,3) → flat index into block_index grid.

    Out-of-range coordinates are clamped; pair with block_in_grid masks."""
    h = spec.half_grid
    bc = jnp.clip(b + h, 0, spec.grid_dim - 1)
    return (bc[..., 0] * spec.grid_dim + bc[..., 1]) * spec.grid_dim + bc[..., 2]


def block_origin(spec: VoxelGridSpec, b: Array) -> Array:
    """Block coordinate (...,3) int32 → world position of its min corner."""
    return b.astype(jnp.float32) * spec.block_size


def voxel_centers_of_block(spec: VoxelGridSpec, b: Array) -> Array:
    """(...,3) block coord → (..., vps,vps,vps, 3) world voxel centers."""
    v = spec.voxels_per_side
    r = jnp.arange(v, dtype=jnp.float32)
    zz, yy, xx = jnp.meshgrid(r, r, r, indexing="ij")
    local = jnp.stack([zz, yy, xx], axis=-1)  # index order (i,j,k) = (x,y,z)
    local = (local + 0.5) * spec.voxel_size
    return block_origin(spec, b)[..., None, None, None, :] + local


# ---------------------------------------------------------------------------
# Allocation
# ---------------------------------------------------------------------------


def allocate_core(spec: VoxelGridSpec, flat_index: Array,
                  block_coords: Array, num_blocks: Array,
                  grid_slots: Array, valid: Array):
    """Allocation on the SMALL layer arrays only (no voxel pools touched):
    flat_index (G³,), block_coords (mb,3), num_blocks () + candidate grid
    slots (N,) with validity mask → updated (flat_index, block_coords,
    num_blocks). Shared by the per-layer and stacked-pool paths."""
    g3 = spec.grid_dim ** 3

    # 1 where some valid candidate touches this grid cell (invalid candidates
    # are redirected out of range and dropped by the scatter).
    touched = jnp.zeros((g3,), dtype=jnp.bool_)
    touched = touched.at[jnp.where(valid, grid_slots, g3)].set(
        True, mode="drop")

    is_new = touched & (flat_index < 0)

    # Assign consecutive pool slots to new blocks.
    order = jnp.cumsum(is_new.astype(jnp.int32)) - 1  # rank among new blocks
    slot_id = num_blocks + order
    can_alloc = is_new & (slot_id < spec.max_blocks)
    new_flat = jnp.where(can_alloc, slot_id, flat_index)
    n_new = jnp.minimum(
        jnp.sum(is_new.astype(jnp.int32)),
        spec.max_blocks - num_blocks,
    )

    # Record block coords for newly-assigned pool slots.
    cell = jnp.arange(g3, dtype=jnp.int32)
    cz = cell % spec.grid_dim
    cy = (cell // spec.grid_dim) % spec.grid_dim
    cx = cell // (spec.grid_dim * spec.grid_dim)
    coords_of_cell = jnp.stack([cx, cy, cz], axis=-1) - spec.half_grid
    pool_target = jnp.where(can_alloc, slot_id, spec.max_blocks)  # drop others
    block_coords_new = block_coords.at[pool_target].set(
        coords_of_cell, mode="drop"
    )
    return new_flat, block_coords_new, num_blocks + n_new, touched


def allocate_and_slots(spec: VoxelGridSpec, flat_index: Array,
                       block_coords: Array, num_blocks: Array,
                       grid_slots: Array, valid: Array, max_touched: int):
    """Fused allocation + touched-slot compaction over the block grid.

    The dedup runs on the SORTED CANDIDATE LIST, never on G³ arrays: sort
    the N candidate cell ids (invalid → G³ sentinel), mark first
    occurrences, and top_k-compact the ≤max_touched smallest unique ids.
    Earlier formulations scattered a G³ touched bitmap (XLA lowers the
    duplicate-index scatter via a sort of the N candidates) and then ran
    TWO G³-sized top_k passes — at the bench operating point N≈58k
    candidates against G³=262k cells, so two N-sized sorts touch far less
    data. New cells are detected by gathering flat_index at the K
    compacted cells (a K-gather instead of a second G³ selection), so
    allocation caps at max_touched NEW cells among the K smallest touched
    — overflow cells stay unallocated and are picked up by later frames,
    as before.
    Returns (flat_index, block_coords, num_blocks, slots (K,), mask (K,)).

    POSTCONDITION (load-bearing): the returned ``slots`` are UNIQUE at
    every mask-True lane — each comes from a distinct grid cell (first
    occurrences of the sorted candidate ids), and a cell maps to exactly
    one pool slot. Downstream pool scatters rely on this to pass
    ``unique_indices=True`` (XLA skips the sort-based duplicate-combine
    lowering); violating it is silent pool corruption. Guarded by an
    opt-in debug check (COXGRAPH_DEBUG_CHECKS=1) in ops.tsdf._alloc_pass."""
    g3 = spec.grid_dim ** 3
    K = max_touched

    # candidate compaction: sort + first-occurrence dedup + top_k of the
    # K smallest unique cell ids → t_cells (K,) ascending, g3-padded
    ids = jnp.sort(jnp.where(valid, grid_slots, g3))      # (N,) ascending
    uniq = jnp.concatenate([ids[:1] < g3,
                            (ids[1:] != ids[:-1]) & (ids[1:] < g3)])
    # negation trick keeps top_k = "smallest"; tiny frames can have fewer
    # candidates than K — pad the selection back out
    k_eff = min(K, ids.shape[0])
    t_cells = -jax.lax.top_k(jnp.where(uniq, -ids, -g3), k_eff)[0]
    if k_eff < K:
        t_cells = jnp.pad(t_cells, (0, K - k_eff), constant_values=g3)
    t_mask = t_cells < g3

    # new-cell detection: K-gather of the block index at the compacted
    # cells (clamped address for padding lanes; t_mask gates the result)
    fi_t = flat_index[jnp.minimum(t_cells, g3 - 1)]
    is_new = t_mask & (fi_t < 0)

    # allocation: consecutive pool slots for new cells, in cell order
    rank = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    slot_id = num_blocks + rank
    can_alloc = is_new & (slot_id < spec.max_blocks)
    n_new = jnp.sum(can_alloc.astype(jnp.int32))
    # small scatters only (K rows, unique targets)
    new_flat = flat_index.at[jnp.where(can_alloc, t_cells, g3)].set(
        jnp.where(can_alloc, slot_id, 0), mode="drop")
    gd = spec.grid_dim
    ncz = t_cells % gd
    ncy = (t_cells // gd) % gd
    ncx = t_cells // (gd * gd)
    coords_new = jnp.stack([ncx, ncy, ncz], axis=-1) - spec.half_grid
    block_coords = block_coords.at[
        jnp.where(can_alloc, slot_id, spec.max_blocks)].set(
        coords_new, mode="drop")
    num_blocks = num_blocks + n_new

    # touched-slot compaction: new cells take their fresh slot, old cells
    # their existing one (no re-gather of new_flat needed)
    slots = jnp.where(is_new, slot_id, fi_t)
    mask = t_mask & (slots >= 0) & (slots < spec.max_blocks)
    slots = jnp.where(mask, slots, spec.max_blocks)
    return new_flat, block_coords, num_blocks, slots, mask


@partial(jax.jit, static_argnums=0)
def allocate_blocks(spec: VoxelGridSpec, layer: TsdfLayer, block_coords: Array,
                    mask: Optional[Array] = None) -> TsdfLayer:
    """Ensure every (masked) block coordinate has a pool slot.

    block_coords: (N,3) int32, possibly with duplicates. Pure scatter +
    prefix-sum; replaces voxblox allocateBlockPtrByCoordinates. Blocks that
    would exceed the pool capacity are silently dropped (callers size
    max_blocks generously; num_blocks saturates at max_blocks).
    """
    g3 = spec.grid_dim ** 3
    slots = block_grid_slot(spec, block_coords)
    valid = block_in_grid(spec, block_coords)
    if mask is not None:
        valid = valid & mask
    new_flat, bc_new, nb_new, _ = allocate_core(
        spec, layer.block_index.reshape(g3), layer.block_coords,
        layer.num_blocks, slots, valid)
    return dataclasses.replace(
        layer,
        block_index=new_flat.reshape(layer.block_index.shape),
        block_coords=bc_new,
        num_blocks=nb_new,
    )


# ---------------------------------------------------------------------------
# Lookup / sampling
# ---------------------------------------------------------------------------


def lookup_block(spec: VoxelGridSpec, layer: TsdfLayer, b: Array) -> Array:
    """Block coordinate (...,3) → pool slot (...,) int32 (-1 if missing)."""
    slot = block_grid_slot(spec, b)
    idx = layer.block_index.reshape(-1)[slot]
    return jnp.where(block_in_grid(spec, b), idx, -1)


def voxel_lookup(spec: VoxelGridSpec, layer: TsdfLayer, v: Array):
    """Global voxel index (...,3) → (sdf, weight, valid_mask).

    Lookups for MISSING blocks get UNIQUE spread dummy addresses, never
    a clamped constant, so dead points do not all hit pool row 0 (the
    same rule as ops/tsdf._update_pass). One flat-view gather per field instead of
    a 2-axis gather."""
    b, l = voxel_to_block(spec, v)
    idx = lookup_block(spec, layer, b)
    vps = spec.voxels_per_side
    lin = (l[..., 0] * vps + l[..., 1]) * vps + l[..., 2]
    v3 = vps * vps * vps
    total = layer.sdf.shape[0] * v3
    flat = idx * v3 + lin
    valid = idx >= 0
    n = 1
    for d in flat.shape:
        n *= d
    spread = jax.lax.broadcasted_iota(
        jnp.int32, (n, 1), 0).squeeze(-1).reshape(flat.shape) % total
    flat = jnp.where(valid, flat, spread)
    sdf = layer.sdf.reshape(-1)[flat]
    w = layer.weight.reshape(-1)[flat]
    return (jnp.where(valid, sdf, spec.truncation),
            jnp.where(valid, w, 0.0), valid)


def sample_tsdf_trilinear(spec: VoxelGridSpec, layer: TsdfLayer, p: Array):
    """Trilinear TSDF interpolation at world points p (...,3).

    Returns (sdf, weight, valid). valid requires all 8 corner voxels to be
    allocated and observed (weight > 0). This is the sampling primitive under
    dense submap registration (reference: voxgraph registration cost,
    server.yaml:28-31) and ESDF queries.
    """
    # voxel centers live at (v + 0.5) * s ⇒ base voxel = floor(p/s - 0.5)
    x = p / spec.voxel_size - 0.5
    v0 = jnp.floor(x).astype(jnp.int32)
    frac = x - v0.astype(x.dtype)

    sdf_acc = jnp.zeros(p.shape[:-1], dtype=layer.sdf.dtype)
    w_acc = jnp.zeros_like(sdf_acc)
    valid = jnp.ones(p.shape[:-1], dtype=jnp.bool_)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                corner = v0 + jnp.array([dx, dy, dz], dtype=jnp.int32)
                s, w, ok = voxel_lookup(spec, layer, corner)
                wt = (
                    (frac[..., 0] if dx else 1 - frac[..., 0])
                    * (frac[..., 1] if dy else 1 - frac[..., 1])
                    * (frac[..., 2] if dz else 1 - frac[..., 2])
                )
                sdf_acc = sdf_acc + wt * s
                w_acc = w_acc + wt * w
                valid = valid & ok & (w > 0)
    return sdf_acc, w_acc, valid


def sample_tsdf_gradient(spec: VoxelGridSpec, layer: TsdfLayer, p: Array,
                         delta: Optional[float] = None):
    """Central-difference TSDF gradient at world points (...,3) → (...,3).

    Returns (grad, valid). Used by registration residual Jacobians."""
    d = spec.voxel_size if delta is None else delta
    grads = []
    valid = jnp.ones(p.shape[:-1], dtype=jnp.bool_)
    for axis in range(3):
        off = jnp.zeros((3,), dtype=p.dtype).at[axis].set(d)
        sp, _, vp = sample_tsdf_trilinear(spec, layer, p + off)
        sm, _, vm = sample_tsdf_trilinear(spec, layer, p - off)
        grads.append((sp - sm) / (2 * d))
        valid = valid & vp & vm
    return jnp.stack(grads, axis=-1), valid


def memory_size_bytes(layer: TsdfLayer) -> int:
    """Total bytes of the pool arrays (cf. voxblox getMemorySize,
    used at coxgraph_server.cpp:281-285 for bandwidth accounting)."""
    return sum(
        x.size * x.dtype.itemsize
        for x in (layer.sdf, layer.weight, layer.color, layer.block_index,
                  layer.block_coords)
    )
