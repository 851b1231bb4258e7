"""Block-sharded ESDF propagation over a device mesh — the spatial
scaling axis of SURVEY.md §5.7: as the map grows past one device's memory, its
voxel blocks shard across devices as x-slabs of the block grid, the
masked-Jacobi ESDF sweeps (ops/esdf.py) run on every shard in parallel,
and only the slab-boundary block faces move over the ICI (ppermute) each
sweep — never raw volumes.

Design: each device owns the blocks whose block-coordinate bx falls in
its slab, stored in a fixed-capacity sub-pool, PLUS two halo regions that
mirror the adjacent slabs' edge blocks. The per-device block-index grid
maps own blocks to own slots and neighbor edge blocks to halo slots, so
the sweep's cross-block gather is IDENTICAL to the single-device one; a
halo refresh after every sweep reproduces global Jacobi semantics exactly
(per-sweep information travel ≤ 1 voxel ≤ 1 block).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..core import voxel as vx
from ..ops import esdf as esdf_ops

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class ShardedEsdfConfig:
    per_device_blocks: int = 1024   # own-block capacity per device
    halo_blocks: int = 256          # edge-block capacity per side
    esdf: esdf_ops.EsdfConfig = esdf_ops.EsdfConfig()


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ShardedBlocks:
    """Per-device slab partition (leaves carry a leading (n_dev,) axis)."""

    coords: Array        # (D, Bd, 3) own block coords
    init: Array          # (D, Bd, v,v,v) ESDF init (band ∪ ±md)
    band: Array          # (D, Bd, v,v,v) frozen surface band
    observed: Array      # (D, Bd, v,v,v)
    live: Array          # (D, Bd) own-block validity
    send_left: Array     # (D, E) own slot ids whose bx == slab min
    send_right: Array    # (D, E) own slot ids whose bx == slab max
    send_left_n: Array   # (D,)
    send_right_n: Array  # (D,)


def slab_bounds(spec: vx.VoxelGridSpec, n_dev: int) -> np.ndarray:
    """Slab boundaries over bx ∈ [-G/2, G/2): n_dev equal slabs."""
    edges = np.linspace(-spec.half_grid, spec.half_grid, n_dev + 1)
    return np.floor(edges).astype(np.int64)


def partition_blocks(spec: vx.VoxelGridSpec, tsdf: vx.TsdfLayer,
                     n_dev: int, cfg: ShardedEsdfConfig) -> ShardedBlocks:
    """Host-side slab partition of a TSDF layer's live blocks (runs once
    per batch rebuild — not the hot loop)."""
    Bd, E = cfg.per_device_blocks, cfg.halo_blocks
    v = spec.voxels_per_side
    md = cfg.esdf.max_distance
    n = int(tsdf.num_blocks)
    coords = np.asarray(tsdf.block_coords)[:n]
    # spatial views of the flat pool rows
    sdf = np.asarray(tsdf.sdf)[:n].reshape(n, v, v, v)
    w = np.asarray(tsdf.weight)[:n].reshape(n, v, v, v)
    observed = w > 1e-6
    band = observed & (np.abs(sdf) < spec.truncation)
    init = np.where(band, sdf, np.where(sdf >= 0, md, -md))
    init = np.where(observed, init, md)

    edges = slab_bounds(spec, n_dev)
    out = {k: [] for k in ("coords", "init", "band", "observed", "live",
                           "send_left", "send_right", "send_left_n",
                           "send_right_n")}
    for d in range(n_dev):
        lo, hi = edges[d], edges[d + 1]
        sel = np.where((coords[:, 0] >= lo) & (coords[:, 0] < hi))[0]
        assert len(sel) <= Bd, (
            f"slab {d} has {len(sel)} blocks > capacity {Bd}")
        k = len(sel)
        c = np.zeros((Bd, 3), np.int32)
        c[:k] = coords[sel]
        # unused slots get far-away coords so they never hit the grid
        c[k:] = spec.half_grid + 7
        ini = np.full((Bd, v, v, v), md, np.float32)
        ini[:k] = init[sel]
        bnd = np.zeros((Bd, v, v, v), bool)
        bnd[:k] = band[sel]
        obs = np.zeros((Bd, v, v, v), bool)
        obs[:k] = observed[sel]
        live = np.zeros((Bd,), bool)
        live[:k] = True
        # edge blocks: the column adjacent to each slab face (a sweep
        # reads ≤ 1 voxel across, so one block column suffices)
        sl = np.where(c[:k, 0] == lo)[0]
        sr = np.where(c[:k, 0] == hi - 1)[0]
        assert len(sl) <= E and len(sr) <= E, "halo capacity exceeded"
        pad = lambda a: np.pad(a.astype(np.int32), (0, E - len(a)))
        out["coords"].append(c)
        out["init"].append(ini)
        out["band"].append(bnd)
        out["observed"].append(obs)
        out["live"].append(live)
        out["send_left"].append(pad(sl))
        out["send_right"].append(pad(sr))
        out["send_left_n"].append(len(sl))
        out["send_right_n"].append(len(sr))
    return ShardedBlocks(
        coords=jnp.asarray(np.stack(out["coords"])),
        init=jnp.asarray(np.stack(out["init"])),
        band=jnp.asarray(np.stack(out["band"])),
        observed=jnp.asarray(np.stack(out["observed"])),
        live=jnp.asarray(np.stack(out["live"])),
        send_left=jnp.asarray(np.stack(out["send_left"])),
        send_right=jnp.asarray(np.stack(out["send_right"])),
        send_left_n=jnp.asarray(np.array(out["send_left_n"], np.int32)),
        send_right_n=jnp.asarray(np.array(out["send_right_n"], np.int32)),
    )


@partial(jax.jit, static_argnums=(0, 1, 3))
def esdf_sharded(spec: vx.VoxelGridSpec, mesh: Mesh, parts: ShardedBlocks,
                 cfg: ShardedEsdfConfig) -> Array:
    """Distributed ESDF sweeps → per-device distance (D, Bd, v,v,v).

    Every device sweeps its own blocks; after each sweep the slab-edge
    block distances ride one ppermute per direction into the neighbors'
    halo slots. Results equal the single-device esdf_from_tsdf exactly
    (same Jacobi schedule)."""
    Bd, E = cfg.per_device_blocks, cfg.halo_blocks
    v = spec.voxels_per_side
    md = cfg.esdf.max_distance
    g3 = spec.grid_dim ** 3
    offs = esdf_ops._neighbor_offsets(cfg.esdf.full_connectivity)
    step = jnp.linalg.norm(offs.astype(jnp.float32),
                           axis=-1) * spec.voxel_size
    n_iters = math.ceil(md / spec.voxel_size) + cfg.esdf.extra_iters
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size

    def shard_fn(coords, init, band, observed, live, s_l, s_r, n_l, n_r):
        # strip the leading (1,) shard axis
        coords, init, band, observed, live, s_l, s_r, n_l, n_r = (
            x[0] for x in (coords, init, band, observed, live, s_l, s_r,
                           n_l, n_r))
        me = jax.lax.axis_index(axis)

        # --- setup: exchange edge coords once; build the local grid ------
        def exch(x_right, x_left):
            """x_right → right neighbor, x_left → left neighbor;
            returns (from_left, from_right)."""
            right = [(i, (i + 1) % n_dev) for i in range(n_dev)]
            left = [(i, (i - 1) % n_dev) for i in range(n_dev)]
            from_left = jax.lax.ppermute(x_right, axis, right)
            from_right = jax.lax.ppermute(x_left, axis, left)
            return from_left, from_right

        # edge coords/masks to neighbors (halo geometry, exchanged once)
        mask_l = (jnp.arange(E) < n_l)
        mask_r = (jnp.arange(E) < n_r)
        safe_l = jnp.minimum(s_l, Bd - 1)
        safe_r = jnp.minimum(s_r, Bd - 1)
        # wrap-around neighbors at the domain ends are masked off
        has_left = me > 0
        has_right = me < n_dev - 1
        halo_l_coords, halo_r_coords = exch(
            (coords[safe_r], mask_r), (coords[safe_l], mask_l))
        hl_c, hl_m = halo_l_coords
        hr_c, hr_m = halo_r_coords
        hl_m = hl_m & has_left
        hr_m = hr_m & has_right

        # local flat grid: own slots [0,Bd), left halo [Bd,Bd+E),
        # right halo [Bd+E, Bd+2E)
        def grid_scatter(fi, cs, ms, base):
            slot = vx.block_grid_slot(spec, cs)
            ok = ms & vx.block_in_grid(spec, cs)
            return fi.at[jnp.where(ok, slot, g3)].set(
                base + jnp.arange(cs.shape[0], dtype=jnp.int32),
                mode="drop")

        flat_index = jnp.full((g3,), -1, jnp.int32)
        flat_index = grid_scatter(flat_index, coords, live, 0)
        flat_index = grid_scatter(flat_index, hl_c, hl_m, Bd)
        flat_index = grid_scatter(flat_index, hr_c, hr_m, Bd + E)

        # voxel world indices per own block
        r = jnp.arange(v, dtype=jnp.int32)
        ii, jj, kk = jnp.meshgrid(r, r, r, indexing="ij")
        local = jnp.stack([ii, jj, kk], axis=-1)
        gvox = coords[:, None, None, None, :] * v + local

        live4 = live[:, None, None, None]
        init_m = jnp.where(live4, init, md)

        def gather_neighbor(dist_ext, off):
            nvox = gvox + off
            b, l = vx.voxel_to_block(spec, nvox)
            slot = vx.block_grid_slot(spec, b)
            idx = jnp.where(vx.block_in_grid(spec, b),
                            flat_index[slot], -1)
            safe = jnp.maximum(idx, 0)
            dn = dist_ext[safe, l[..., 0], l[..., 1], l[..., 2]]
            return jnp.where(idx >= 0, dn, md)

        # face-neighbor block indices per OWN block into the EXTENDED
        # (own + halos) pool — hoisted; lets the sweep's 6-connectivity
        # part run as shifts + face-plane gathers instead of the
        # gather-unit-serializing per-voxel gather (ops/esdf.py)
        face_idx = esdf_ops.face_neighbor_indices(spec, coords, flat_index)
        offs_np = [tuple(int(c) for c in o) for o in offs.tolist()]

        def refresh_halo(dist_ext):
            own = dist_ext[:Bd]
            from_l, from_r = exch(own[safe_r], own[safe_l])
            dist_ext = jax.lax.dynamic_update_slice_in_dim(
                dist_ext, jnp.where(hl_m[:, None, None, None], from_l, md),
                Bd, axis=0)
            dist_ext = jax.lax.dynamic_update_slice_in_dim(
                dist_ext, jnp.where(hr_m[:, None, None, None], from_r, md),
                Bd + E, axis=0)
            return dist_ext

        def sweep(dist_ext, _):
            d = dist_ext[:Bd]
            pos_best = jnp.full_like(d, md)
            neg_best = jnp.full_like(d, -md)
            for a in range(len(offs_np)):
                o = offs_np[a]
                if sum(abs(c) for c in o) == 1:
                    dn = esdf_ops.axis_neighbor_field(
                        dist_ext, d, face_idx, o, v, md)
                else:
                    dn = gather_neighbor(dist_ext, offs[a])
                pos_best = jnp.minimum(pos_best,
                                       jnp.maximum(dn, 0.0) + step[a])
                neg_best = jnp.maximum(neg_best,
                                       jnp.minimum(dn, 0.0) - step[a])
            d_new = jnp.where(d >= 0, jnp.minimum(d, pos_best),
                              jnp.maximum(d, neg_best))
            d_new = jnp.where(band, init_m, d_new)
            d_new = jnp.where(live4, d_new, md)
            dist_ext = jax.lax.dynamic_update_slice_in_dim(
                dist_ext, d_new, 0, axis=0)
            return refresh_halo(dist_ext), None

        dist_ext = jnp.concatenate(
            [init_m, jnp.full((2 * E, v, v, v), md)], axis=0)
        dist_ext = refresh_halo(dist_ext)
        dist_ext, _ = jax.lax.scan(sweep, dist_ext, None, length=n_iters)
        out = jnp.clip(dist_ext[:Bd], -md, md)
        return out[None]

    return shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis),) * 9,
        out_specs=P(axis),
        check_vma=False,
    )(parts.coords, parts.init, parts.band, parts.observed, parts.live,
      parts.send_left, parts.send_right, parts.send_left_n,
      parts.send_right_n)


def gather_to_layer(spec: vx.VoxelGridSpec, tsdf: vx.TsdfLayer,
                    parts: ShardedBlocks, dist: Array
                    ) -> esdf_ops.EsdfLayer:
    """Merge per-device shard results back into an EsdfLayer aligned with
    the source TSDF layer's pool (host-side, export path)."""
    md = float(np.max(np.abs(np.asarray(dist))))
    v = spec.voxels_per_side
    n = int(tsdf.num_blocks)
    key = {tuple(c): k for k, c in
           enumerate(np.asarray(tsdf.block_coords)[:n].tolist())}
    out = np.full((tsdf.max_blocks, v, v, v), md, np.float32)
    coords = np.asarray(parts.coords)
    live = np.asarray(parts.live)
    d = np.asarray(dist)
    for dev in range(coords.shape[0]):
        for s in range(coords.shape[1]):
            if not live[dev, s]:
                continue
            k = key.get(tuple(coords[dev, s].tolist()))
            if k is not None:
                out[k] = d[dev, s]
    return esdf_ops.EsdfLayer(
        dist=jnp.asarray(out.reshape(tsdf.max_blocks, -1)),  # flat rows
        observed=(tsdf.weight > 1e-6),
        block_index=tsdf.block_index,
        block_coords=tsdf.block_coords,
        num_blocks=tsdf.num_blocks,
    )


def ici_bytes_per_update(spec: vx.VoxelGridSpec,
                         cfg: ShardedEsdfConfig) -> dict:
    """Static ICI traffic accounting for one sharded ESDF batch update —
    the exchange-layer byte counters promised by SURVEY.md §5.1/§5.8
    (node_evaluator bandwidth parity for the intra-slice fabric). All
    collective payloads here have static shapes, so the counts are exact:
    each halo refresh moves the edge-block distances (halo_blocks · v³
    f32) once per direction per device, once at setup plus once per
    Jacobi sweep; setup additionally ships edge coords + masks."""
    v3 = spec.voxels_per_side ** 3
    n_sweeps = math.ceil(cfg.esdf.max_distance / spec.voxel_size) \
        + cfg.esdf.extra_iters
    per_refresh = 2 * cfg.halo_blocks * v3 * 4          # both directions
    setup = 2 * cfg.halo_blocks * (3 * 4 + 1)           # coords + mask
    return {
        "n_sweeps": n_sweeps,
        "per_sweep_bytes": per_refresh,
        "per_device_bytes": setup + (n_sweeps + 1) * per_refresh,
    }
