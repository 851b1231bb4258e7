"""Client-side merged-map server — parity with the reference MapServer
(coxgraph/include/coxgraph/client/map_server.h:26-162,
src/client/map_server.cpp:12-152).

The reference MapServer keeps a merged odom-frame TSDF of all submaps
(rebuilt after submap pose changes, `updatePastTsdf` map_server.cpp:59-73),
batch-updates an ESDF from it (map_server.h:141-145), publishes a
traversability pointcloud (free space with robot-radius clearance,
map_server.cpp:109-117), and publishes each finished submap's mesh with a
keyframe-filtered trajectory (map_server.cpp:119-152; keyframe stamps
tracked from the `keyframe_pose` topic, map_server.h:149-156).

Accelerator design: no topics or timers — the merged TSDF/ESDF are cached device
arrays invalidated by pose updates and rollovers; "publishing" is returning
arrays (or wire messages for the bus). The ESDF batch update is the jitted
masked-Jacobi sweep from ops/esdf.py; traversability is a fixed-capacity
masked point set straight off the ESDF pool.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..core import voxel as vx
from ..ops import esdf as esdf_ops
from . import submap_mapper as sm


@dataclasses.dataclass(frozen=True)
class MapServerConfig:
    """Reference config block at map_server.h:26-60 (publish intervals in
    submap counts; traversability radius)."""

    esdf: esdf_ops.EsdfConfig = esdf_ops.EsdfConfig()
    robot_radius: float = 0.5          # m clearance for traversability
    keyframe_stride: int = 4           # fallback mesh-history subsample
    keyframe_tolerance: float = 0.025  # s stamp match (half a 20 Hz frame)


class MapServer:
    """Merged-map queries over a mapper's SubmapCollection with caching.

    Pure pull API: callers ask for the merged TSDF / ESDF / traversability
    whenever they need it; `notify_pose_update()` (the reference's
    map-pose-updates subscription) invalidates the cache.
    """

    def __init__(self, cfg: sm.MapperConfig,
                 ms_cfg: MapServerConfig = MapServerConfig()):
        self.cfg = cfg
        self.ms_cfg = ms_cfg
        self._tsdf: Optional[vx.TsdfLayer] = None
        self._esdf: Optional[esdf_ops.EsdfLayer] = None
        self._built_for: int = -1       # num_submaps the cache was built at
        self._dirty: bool = True
        self._keyframe_stamps: list = []

    # -- invalidation ------------------------------------------------------

    def notify_pose_update(self) -> None:
        """Submap poses changed (local PGO / server push) → rebuild merged
        maps on next query (reference map_server.cpp:59-73 trigger)."""
        self._dirty = True

    def _refresh(self, col: sm.SubmapCollection) -> None:
        n = int(col.num_submaps)
        if not self._dirty and n == self._built_for and self._tsdf is not None:
            return
        self._tsdf = sm.merged_layer(self.cfg, col)
        self._esdf = None               # lazily rebuilt from the new TSDF
        self._built_for = n
        self._dirty = False

    # -- merged map queries ------------------------------------------------

    def merged_tsdf(self, col: sm.SubmapCollection) -> vx.TsdfLayer:
        """Odom-frame merged TSDF of all submaps (updatePastTsdf)."""
        self._refresh(col)
        return self._tsdf

    def merged_esdf(self, col: sm.SubmapCollection) -> esdf_ops.EsdfLayer:
        """Batch ESDF from the merged TSDF (updateEsdfBatch,
        map_server.h:141-145)."""
        self._refresh(col)
        if self._esdf is None:
            self._esdf = esdf_ops.esdf_from_tsdf(
                self.cfg.spec, self._tsdf, self.ms_cfg.esdf)
        return self._esdf

    def traversability(self, col: sm.SubmapCollection
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Free-space voxel centers with > robot_radius clearance →
        (points (N,3), mask (N,)) (map_server.cpp:109-117)."""
        esdf = self.merged_esdf(col)
        return esdf_ops.traversable_points(
            self.cfg.spec, esdf, self.ms_cfg.robot_radius)

    # -- keyframe tracking + submap mesh publication ------------------------

    def add_keyframe(self, stamp: float) -> None:
        """Register a VIO keyframe stamp (the reference subscribes to
        `keyframe_pose`, map_server.h:149-156)."""
        self._keyframe_stamps.append(float(stamp))

    def keyframe_history(self, col: sm.SubmapCollection, k: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Submap k's pose history filtered to registered keyframes
        (publishSubmapMesh keyframe filter, map_server.cpp:119-152).
        Falls back to a stride subsample when no keyframes are registered."""
        h = int(col.hist_count[k])
        stamps = np.asarray(col.hist_stamps[k][:h], np.float64)
        poses = np.asarray(col.hist_poses[k][:h], np.float32)
        if not self._keyframe_stamps:
            sel = np.arange(0, h, max(1, self.ms_cfg.keyframe_stride))
        else:
            kf = np.asarray(self._keyframe_stamps, np.float64)
            d = np.abs(stamps[:, None] - kf[None, :])
            sel = np.nonzero(d.min(axis=1) <= self.ms_cfg.keyframe_tolerance)[0]
        return stamps[sel], poses[sel]

    def submap_mesh_msg(self, col: sm.SubmapCollection, k: int,
                        intr, client_id: int = 0, soup=None):
        """Finished submap k as a MeshWithHistory wire message with a
        keyframe-filtered trajectory — the reference's submap_mesh_with_traj
        output (map_server.cpp:119-152).

        ``soup``: optional precomputed triangle soup (e.g.
        HostMapper.live_mesh(k) — the incremental changed-blocks mesh);
        skips the full-layer re-extraction for frame-rate publishing."""
        from ..comm import mesh_comm

        stamps, poses = self.keyframe_history(col, k)
        layer = sm.get_layer(col.layers, jnp.asarray(k))
        return mesh_comm.encode_submap_mesh(
            self.cfg.spec, layer, stamps, poses, intr,
            client_id=client_id, submap_id=k,
            keyframe_stride=1,   # already keyframe-filtered above
            soup=soup,
        )
