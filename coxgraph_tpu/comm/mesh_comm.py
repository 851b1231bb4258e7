"""Mesh-with-history transport — the reference's L2 map-communication tier
(SURVEY.md §2.4): ship a compact submap *mesh* whose triangles remember
which keyframe observed them, decode it into per-keyframe pointclouds, and
re-integrate those into a fresh TSDF at the receiver.

Reference capabilities re-provided here:
  * MeshConverter (mesh_converter.h:93-265): uint16-quantized vertex
    decoding, extra-point interpolation along triangle edges + centroid at
    ``interpolate_voxel_size`` spacing with color blending, and bucketing
    of points by observing-frame timestamp;
  * TsdfRecover (tsdf_recover.h:59-99): mesh → pointclouds → re-integrated
    TSDF layer via the standard integrator.

Accelerator-first shifts: the wire mesh is an *indexed* mesh vertex-clustered to
voxel resolution (ops/mesh_post) — the marching-tetrahedra soup is ~6x
redundant, and clustering is the lossless-at-voxel-scale way to hit the
bandwidth target the reference gets from voxblox's per-block vertex
sharing. The observation history is an explicit per-triangle keyframe id
assigned by best-view analysis at encode time (the reference piggybacks on
voxblox integrator bookkeeping). Re-integration renders each keyframe's
points into a virtual depth/color image with a z-buffer scatter (one jit)
and reuses the projective TSDF integrator — point-based ray-casting would
serialize scattered per-ray work, a dense virtual frame does not.

Note this transport is OPTIONAL here: comm/wire.py ships quantized voxel
blocks directly (no lossy round trip) and is the default. mesh_comm exists
for parity + for bandwidth-starved deployments (it carries only the
surface crust, not the truncation band).
"""

from __future__ import annotations

import dataclasses
import struct
from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import geometry as geo
from ..core import voxel as vx
from ..frontends.synthetic import PinholeIntrinsics
from ..ops import mesh as mesh_ops
from ..ops import mesh_post
from ..ops import tsdf as tsdf_ops

Array = jax.Array

_HDR = struct.Struct("<II II II dd 3f f")  # cid, csid, n_verts, n_faces,
#                                  n_kf, max_runs, t0, t1, aabb_min, scale

RUN_SENTINEL = 0xFFFF   # unused observation-run slot


@dataclasses.dataclass
class MeshWithHistory:
    """The wire message (coxgraph_msgs/MeshWithTrajectory equivalent:
    voxblox MultiMesh + nav_msgs/Path, MeshWithTrajectory.msg)."""

    client_id: int
    submap_id: int
    t0: float
    t1: float
    aabb_min: np.ndarray       # (3,) f32
    scale: float               # quantization step (m per uint16 LSB)
    qverts: np.ndarray         # (V,3) uint16 — quantized submap-frame verts
    vcolors: np.ndarray        # (V,3) uint8
    faces: np.ndarray          # (F,3) uint32
    frame_runs: np.ndarray     # (F,P,2) uint16 — [start,end] keyframe-index
    #                            observation runs per face (unused slots =
    #                            RUN_SENTINEL), the reference's per-triangle
    #                            run-length history (mesh_converter.h:137-142)
    kf_stamps: np.ndarray      # (K,) f64
    kf_poses: np.ndarray       # (K,7) f32 T_submap_cam

    @property
    def frame_idx(self) -> np.ndarray:
        """(F,) first observing keyframe per face — the chronologically
        earliest start across the face's observation runs (runs are stored
        ranked by LENGTH, so run 0's start is not necessarily first;
        ADVICE r3). Faces with no runs fall back to 0."""
        if self.frame_runs.shape[0] == 0:
            return np.zeros((0,), np.uint16)
        starts = self.frame_runs[:, :, 0].astype(np.int32)
        starts = np.where(starts == RUN_SENTINEL, np.iinfo(np.int32).max,
                          starts)
        first = starts.min(axis=1)
        return np.where(first == np.iinfo(np.int32).max, 0,
                        first).astype(np.uint16)

    def pack(self) -> bytes:
        """→ bytes (the ROS-serialization equivalent; sizeOfMsg analogue
        for bandwidth accounting, msg_converter.h:149-167)."""
        head = _HDR.pack(self.client_id, self.submap_id,
                         self.qverts.shape[0], self.faces.shape[0],
                         self.kf_stamps.shape[0], self.frame_runs.shape[1],
                         self.t0, self.t1, *map(float, self.aabb_min),
                         self.scale)
        # face indices ride as u16 whenever the clustered vertex count
        # allows (it virtually always does) — they dominate the payload
        fdtype = np.uint16 if self.qverts.shape[0] <= 0xFFFF else np.uint32
        return b"".join([
            head,
            np.ascontiguousarray(self.qverts, np.uint16).tobytes(),
            np.ascontiguousarray(self.vcolors, np.uint8).tobytes(),
            np.ascontiguousarray(self.faces.astype(fdtype)).tobytes(),
            np.ascontiguousarray(self.frame_runs, np.uint16).tobytes(),
            np.ascontiguousarray(self.kf_stamps, np.float64).tobytes(),
            np.ascontiguousarray(self.kf_poses, np.float32).tobytes(),
        ])

    @staticmethod
    def unpack(buf: bytes) -> "MeshWithHistory":
        (cid, csid, V, F, K, P, t0, t1, ax, ay, az,
         scale) = _HDR.unpack_from(buf, 0)
        off = _HDR.size
        qverts = np.frombuffer(buf, np.uint16, V * 3, off).reshape(V, 3)
        off += V * 6
        vcolors = np.frombuffer(buf, np.uint8, V * 3, off).reshape(V, 3)
        off += V * 3
        fdtype = np.uint16 if V <= 0xFFFF else np.uint32
        faces = np.frombuffer(buf, fdtype, F * 3, off).reshape(
            F, 3).astype(np.uint32)
        off += F * 3 * fdtype().itemsize
        frame_runs = np.frombuffer(buf, np.uint16, F * P * 2,
                                   off).reshape(F, P, 2)
        off += F * P * 4
        kf_stamps = np.frombuffer(buf, np.float64, K, off)
        off += K * 8
        kf_poses = np.frombuffer(buf, np.float32, K * 7, off).reshape(K, 7)
        return MeshWithHistory(cid, csid, t0, t1,
                               np.array([ax, ay, az], np.float32), scale,
                               qverts.copy(), vcolors.copy(), faces.copy(),
                               frame_runs.copy(), kf_stamps.copy(),
                               kf_poses.copy())

    @property
    def nbytes(self) -> int:
        fb = 6 if self.qverts.shape[0] <= 0xFFFF else 12
        return (_HDR.size + self.qverts.shape[0] * 9
                + self.faces.shape[0] * (fb + 4 * self.frame_runs.shape[1])
                + self.kf_stamps.shape[0] * 36)

    def vertices(self) -> np.ndarray:
        """Dequantized submap-frame vertices (V,3) f32 (MeshConverter
        uint16 decode, mesh_converter.h:93-110)."""
        return (self.qverts.astype(np.float32) * self.scale
                + self.aabb_min[None, :])


# ---------------------------------------------------------------------------
# Encode (sender side)
# ---------------------------------------------------------------------------


def _project_np(intr: PinholeIntrinsics, p_cam: np.ndarray):
    """Points in camera frame (N,3) → (u, v, z, in_image)."""
    z = p_cam[:, 2]
    zs = np.maximum(z, 1e-6)
    u = p_cam[:, 0] / zs * intr.fx + intr.cx
    v = p_cam[:, 1] / zs * intr.fy + intr.cy
    ok = (z > 0.05) & (u >= 0) & (u < intr.width) & (v >= 0) & (v < intr.height)
    return u, v, z, ok


def _visibility_runs(ok: np.ndarray, nidx: np.ndarray,
                     max_runs: int) -> np.ndarray:
    """Per-face in-frustum mask over keyframes (F,K) bool → run-length
    observation history (F, max_runs, 2) u16 [start,end] inclusive, the
    ``max_runs`` LONGEST runs per face (reference history is an
    unbounded vector of pairs, mesh_converter.h:137-142; two slots cover
    >99% of faces on orbit-style trajectories — extra runs are dropped
    longest-first). Faces visible in no keyframe get the degenerate run
    [nidx, nidx] (nearest keyframe) so decode still places them."""
    F, K = ok.shape
    runs = np.full((F, max_runs, 2), RUN_SENTINEL, np.uint16)
    if F == 0:
        return runs
    padded = np.zeros((F, K + 2), bool)
    padded[:, 1:-1] = ok
    d = np.diff(padded.astype(np.int8), axis=1)       # (F, K+1)
    f_s, k_s = np.nonzero(d == 1)                     # run starts
    f_e, k_e = np.nonzero(d == -1)                    # run ends (excl.)
    # starts/ends pair up in order within each face row
    lengths = k_e - k_s
    order = np.lexsort((-lengths, f_s))
    f_o, s_o, e_o = f_s[order], k_s[order], k_e[order] - 1
    # rank of each run within its face (0 = longest)
    first = np.searchsorted(f_o, f_o)
    rank = np.arange(len(f_o)) - first
    keep = rank < max_runs
    runs[f_o[keep], rank[keep], 0] = s_o[keep]
    runs[f_o[keep], rank[keep], 1] = e_o[keep]
    unseen = ~ok.any(axis=1)
    runs[unseen, 0, 0] = nidx[unseen]
    runs[unseen, 0, 1] = nidx[unseen]
    return runs


def encode_submap_mesh(spec: vx.VoxelGridSpec, layer: vx.TsdfLayer,
                       hist_stamps: np.ndarray, hist_poses: np.ndarray,
                       intr: PinholeIntrinsics,
                       client_id: int = 0, submap_id: int = 0,
                       keyframe_stride: int = 4,
                       min_weight: float = 1e-4,
                       cluster_scale: float = 1.5,
                       max_obs_runs: int = 2,
                       soup=None) -> MeshWithHistory:
    """Submap → MeshWithHistory: extract the mesh, vertex-cluster it to
    ≈cluster_scale·voxel_size, subsample the pose history into keyframes,
    and record every face's run-length observation history (the contiguous
    keyframe ranges whose frustum sees its centroid — the reference's
    per-triangle [start,end] pairs, mesh_converter.h:137-142). Replaces
    the voxblox mesh_with_history emission consumed at
    tsdf_recover.h:119-136.

    ``soup``: optional precomputed (verts (T,3,3), colors (T,3,3))
    triangle soup — pass an IncrementalMesher's cached mesh to skip the
    full-layer re-extraction (the reference's MeshIntegrator hands the
    converter its incrementally-maintained mesh layer the same way)."""
    if soup is not None:
        soup_v, soup_c = soup
    else:
        soup_v, soup_c = mesh_ops.extract_mesh(spec, layer,
                                               min_weight=min_weight)
    mesh = mesh_post.connect_soup(soup_v, soup_c)
    mesh = mesh_post.simplify_vertex_clustering(
        mesh, cluster_scale * spec.voxel_size)
    hist_stamps = np.asarray(hist_stamps, np.float64)
    hist_poses = np.asarray(hist_poses, np.float32)
    kf = np.arange(0, max(len(hist_stamps), 1), keyframe_stride)
    kf_stamps = hist_stamps[kf] if len(hist_stamps) else np.zeros((1,))
    kf_poses = (hist_poses[kf] if len(hist_poses)
                else np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32),
                             (1, 1)))

    if mesh.n_vertices == 0:
        return MeshWithHistory(
            client_id, submap_id,
            float(kf_stamps[0]), float(kf_stamps[-1]),
            np.zeros(3, np.float32), spec.voxel_size / 64.0,
            np.zeros((0, 3), np.uint16), np.zeros((0, 3), np.uint8),
            np.zeros((0, 3), np.uint32),
            np.full((0, max_obs_runs, 2), RUN_SENTINEL, np.uint16),
            kf_stamps, kf_poses)

    centroids = mesh.vertices[mesh.faces].mean(axis=1)   # (F,3)
    # per-keyframe visibility of each face centroid (+ nearest keyframe
    # as the fallback for faces outside every frustum)
    K = kf_poses.shape[0]
    ok_mat = np.zeros((centroids.shape[0], K), bool)
    nearest = np.full(centroids.shape[0], np.inf)
    nidx = np.zeros(centroids.shape[0], np.uint16)
    for k in range(K):
        T_cam_sm = geo.inverse_np(kf_poses[k])
        p_cam = geo.transform_points_np(T_cam_sm, centroids)
        _, _, _, ok = _project_np(intr, p_cam)
        ok_mat[:, k] = ok
        d = np.linalg.norm(p_cam, axis=1)
        near_upd = d < nearest
        nearest[near_upd] = d[near_upd]
        nidx[near_upd] = k
    runs = _visibility_runs(ok_mat, nidx, max_obs_runs)

    aabb_min = mesh.vertices.min(axis=0)
    extent = mesh.vertices.max(axis=0) - aabb_min
    scale = max(float(extent.max()) / 65535.0, 1e-6)
    q = np.clip((mesh.vertices - aabb_min[None, :]) / scale, 0,
                65535).astype(np.uint16)
    c8 = (np.clip(mesh.colors * 255.0, 0, 255).astype(np.uint8)
          if mesh.colors is not None
          else np.zeros((mesh.n_vertices, 3), np.uint8))
    return MeshWithHistory(
        client_id, submap_id, float(kf_stamps[0]), float(kf_stamps[-1]),
        aabb_min.astype(np.float32), scale, q, c8,
        mesh.faces.astype(np.uint32), runs, kf_stamps, kf_poses)


# ---------------------------------------------------------------------------
# Decode (receiver side) — MeshConverter equivalent
# ---------------------------------------------------------------------------


def _bary_lattice(level: int) -> np.ndarray:
    """Barycentric lattice weights for subdivision level ℓ:
    {(i,j,ℓ-i-j)/ℓ} — includes corners, edge points and interior
    (centroid for ℓ=3k) — ((ℓ+1)(ℓ+2)/2, 3)."""
    pts = []
    for i in range(level + 1):
        for j in range(level + 1 - i):
            pts.append((i, j, level - i - j))
    return np.asarray(pts, np.float64) / level


def decode_to_pointclouds(msg: MeshWithHistory,
                          interpolate_voxel_size: float = 0.05,
                          max_level: int = 4
                          ) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """MeshWithHistory → {keyframe id: (sensor-frame points (N,3),
    colors (N,3) f32)}. Each triangle emits a barycentric lattice of
    points at ≈ interpolate_voxel_size spacing with blended colors
    (interpolateTriangle, mesh_converter.h:211-265) into the pointcloud
    of EVERY keyframe covered by its observation runs — the reference
    expands each [start,end] pair into per-frame buckets
    (mesh_converter.h:137-159), so multiply-observed surface is
    re-integrated with multi-view weight, matching voxblox's
    multi-observation averaging — then transforms each bucket into its
    keyframe's sensor frame (getNextPointcloud, :186-209)."""
    if msg.faces.shape[0] == 0:
        return {}
    tri_v = msg.vertices()[msg.faces]                    # (F,3,3)
    tri_c = (msg.vcolors.astype(np.float32) / 255.0)[msg.faces]
    edge = np.linalg.norm(
        tri_v - tri_v[:, [1, 2, 0], :], axis=-1).max(axis=1)   # (F,)
    level = np.clip(np.ceil(edge / max(interpolate_voxel_size, 1e-6)
                            ).astype(np.int64), 1, max_level)

    pts_parts, col_parts, fid_parts = [], [], []
    for lv in range(1, max_level + 1):
        sel = level == lv
        if not np.any(sel):
            continue
        w = _bary_lattice(lv)                            # (P,3)
        p = np.einsum("pk,tkd->tpd", w, tri_v[sel])      # (t,P,3)
        c = np.einsum("pk,tkd->tpd", w, tri_c[sel])
        f = np.repeat(np.nonzero(sel)[0], w.shape[0])    # face id per pt
        pts_parts.append(p.reshape(-1, 3))
        col_parts.append(c.reshape(-1, 3))
        fid_parts.append(f)
    pts = np.concatenate(pts_parts).astype(np.float32)
    cls = np.concatenate(col_parts).astype(np.float32)
    fids = np.concatenate(fid_parts)

    runs = msg.frame_runs                                # (F,P,2)
    out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for k in range(msg.kf_poses.shape[0]):
        face_sees_k = ((runs[:, :, 0] <= k)
                       & (k <= runs[:, :, 1])).any(axis=1)    # (F,)
        m = face_sees_k[fids]
        if not np.any(m):
            continue
        T_cam_sm = geo.inverse_np(msg.kf_poses[k])
        out[k] = (geo.transform_points_np(T_cam_sm, pts[m]), cls[m])
    return out


# ---------------------------------------------------------------------------
# Recover (receiver side) — TsdfRecover equivalent
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(0,))
def _render_points(intr: PinholeIntrinsics, pts_cam: Array, cols: Array,
                   valid: Array) -> Tuple[Array, Array]:
    """Z-buffer point splat: sensor-frame points → (depth (H,W),
    color (H,W,3)). Nearest point wins per pixel (sorted-scatter)."""
    H, W = intr.height, intr.width
    z = pts_cam[:, 2]
    zs = jnp.maximum(z, 1e-6)
    u = jnp.round(pts_cam[:, 0] / zs * intr.fx + intr.cx).astype(jnp.int32)
    v = jnp.round(pts_cam[:, 1] / zs * intr.fy + intr.cy).astype(jnp.int32)
    ok = valid & (z > 0.05) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    lin = jnp.where(ok, v * W + jnp.clip(u, 0, W - 1), H * W)
    depth = jnp.full((H * W,), jnp.inf, jnp.float32)
    depth = depth.at[lin].min(z, mode="drop")
    # nearest-wins color: scatter in descending-z order (last write wins)
    order = jnp.argsort(jnp.where(ok, -z, -jnp.inf))
    color = jnp.zeros((H * W, 3), jnp.float32)
    color = color.at[lin[order]].set(cols[order], mode="drop")
    depth = jnp.where(jnp.isfinite(depth), depth, 0.0)
    return depth.reshape(H, W), color.reshape(H, W, 3)


def render_points(intr: PinholeIntrinsics, pts_cam: np.ndarray,
                  cols: np.ndarray) -> Tuple[Array, Array]:
    """Host wrapper: pads to power-of-two buckets (bounded jit cache)."""
    n = pts_cam.shape[0]
    cap = max(1 << (max(n, 1) - 1).bit_length(), 256)
    p = np.zeros((cap, 3), np.float32)
    c = np.zeros((cap, 3), np.float32)
    m = np.zeros((cap,), bool)
    p[:n] = pts_cam
    c[:n] = cols
    m[:n] = True
    return _render_points(intr, jnp.asarray(p), jnp.asarray(c),
                          jnp.asarray(m))


def recover_layer(spec: vx.VoxelGridSpec, cfg: tsdf_ops.TsdfIntegratorConfig,
                  intr: PinholeIntrinsics, msg: MeshWithHistory,
                  interpolate_voxel_size: Optional[float] = None,
                  method: str = "projective",
                  use_const_weight: bool = True) -> vx.TsdfLayer:
    """Rebuild a TSDF layer from a MeshWithHistory (TsdfRecover::processMesh,
    tsdf_recover.h:59-99). ``method`` selects the re-integration path
    (voxblox configures its integrator per node via the ``method`` param;
    the recover node uses "fast", tsdf_recover.yaml:6):

    - "projective": per keyframe, z-buffer-splat the pointcloud into a
      virtual RGB-D frame and run the projective frame integrator;
    - "merged": feed each keyframe cloud straight to the bundling
      pointcloud integrator (ops/points.py) — no virtual frame, no
      pinhole assumption on the receiver.

    ``use_const_weight=True`` (default) disables 1/d² distance weighting
    for the re-integration, matching the reference recover node's
    use_const_weight: true (tsdf_recover.yaml:11) — mesh-decoded points
    have no sensor-noise model, so distance weighting is meaningless.
    """
    space = (interpolate_voxel_size if interpolate_voxel_size is not None
             else spec.voxel_size)
    if use_const_weight:
        cfg = dataclasses.replace(cfg, use_distance_weight=False)
    clouds = decode_to_pointclouds(msg, interpolate_voxel_size=space)
    layer = vx.create_tsdf_layer(spec)
    if method == "merged":
        from ..ops import points as pts_ops
        pcfg = pts_ops.PointIntegratorConfig(
            max_range=cfg.max_range, min_range=cfg.min_range,
            max_weight=cfg.max_weight,
            max_touched_blocks=cfg.max_touched_blocks,
            use_distance_weight=cfg.use_distance_weight,
            use_dropoff=cfg.use_dropoff)
        # ONE capacity from the largest cloud in the message: per-cloud
        # power-of-two buckets compiled a fresh integrate_points program
        # per distinct bucket (a fresh compile per message)
        # default=0 keeps the empty-mesh message (decode returns {}) a
        # no-op instead of a ValueError (ADVICE r3)
        n_max = max((c[0].shape[0] for c in clouds.values()), default=0)
        cap = max(1 << (max(n_max, 1) - 1).bit_length(), 256)
        for k in sorted(clouds):
            pts_cam, cols = clouds[k]
            n = pts_cam.shape[0]
            p = np.zeros((cap, 3), np.float32)
            c = np.zeros((cap, 3), np.float32)
            m = np.zeros((cap,), bool)
            p[:n], c[:n], m[:n] = pts_cam, cols, True
            layer = pts_ops.integrate_points(
                spec, pcfg, layer, jnp.asarray(p), jnp.asarray(c),
                jnp.asarray(m), jnp.asarray(msg.kf_poses[k]))
        return layer
    if method != "projective":
        raise ValueError(f"unknown recover method {method!r}")
    for k in sorted(clouds):
        pts_cam, cols = clouds[k]
        depth, color = render_points(intr, pts_cam, cols)
        layer = tsdf_ops.integrate_frame(
            spec, cfg, intr, layer, depth, color,
            jnp.asarray(msg.kf_poses[k]))
    return layer
