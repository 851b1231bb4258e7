"""VIO adapter facade — the coxgraph_mod equivalent (vio_interface.h:17-140:
updatePose, publishLoopClosure, toggleMapping, needToFuse/updateNeedToFuse
caching; loop_closure_publisher.h routing; tf_publisher.h odometry out).

In the reference this header-only library is compiled INTO external SLAM
binaries and talks ROS; here it is the Python facade an odometry frontend
(or the synthetic replay driver) uses to feed the device pipeline. It routes:
pose updates → the robot's mapper step, cross-robot loop closures →
server.map_fusion, same-robot ones → the same path (the server forwards
them back as local constraints), and caches need-to-fuse answers.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import geometry as geo
from ..mapper import submap_mapper as sm
from ..server.fusion_server import CoxgraphServer, MapFusionMsg

Array = jax.Array

# ORB-SLAM camera convention (z forward, y down) → ROS/world (x forward,
# z up) change-of-basis (tf_orb_to_ros, tf_publisher.h:187)
_ORB_TO_ROS = np.array([[0.0, 0.0, 1.0],
                        [-1.0, 0.0, 0.0],
                        [0.0, -1.0, 0.0]])


def pose_from_orbslam(T_cw: np.ndarray) -> Array:
    """ORB-SLAM tracker output T_cw (4x4 camera-from-world, ORB axes) →
    T_odom_cam pose (7,) in the world convention — the reference's
    TransformFromTf chain: rebase to ROS axes, invert to world-from-
    camera, rebase again (tf_publisher.h:184-205)."""
    T_cw = np.asarray(T_cw, np.float64)
    R = _ORB_TO_ROS @ T_cw[:3, :3]
    t = _ORB_TO_ROS @ T_cw[:3, 3]
    R = R.T
    t = -(R @ t)
    R = _ORB_TO_ROS @ R
    t = _ORB_TO_ROS @ t
    q = geo.matrix_to_quat(jnp.asarray(R, jnp.float32))
    return geo.make(q, jnp.asarray(t, jnp.float32))


class VIOInterface:
    def __init__(self, client_id: int, cfg: sm.MapperConfig,
                 client, server: Optional[CoxgraphServer] = None):
        """client: server.client_interface.InProcessClient for this robot."""
        self.client_id = client_id
        self.cfg = cfg
        self.client = client
        self.server = server
        self.mapping_enabled = True
        self._need_to_fuse_cache: Dict[Tuple[int, int], bool] = {}
        self.T_odom_latest: Optional[Array] = None
        # optional IMU extrinsics chain T_odom_imu · T_imu_sensor
        # (tf_publisher.h:76-100)
        self.T_imu_sensor: Optional[Array] = None
        # host-side rollover mirror: zero device reads in the frame loop
        self._mapper = sm.HostMapper(cfg, client.state)

    # vio_interface.h:34-44 updatePose — odometry in, mapping step out
    def update_pose(self, T_odom_cam: Array, t: float,
                    depth: Optional[Array] = None,
                    color: Optional[Array] = None) -> None:
        self.T_odom_latest = T_odom_cam
        if self.mapping_enabled and depth is not None:
            # hold the client's pause lock across the read-modify-write:
            # with async PGO the server's solve thread pushes pose updates
            # concurrently (submap_proc_mutex_ parity, coxgraph_client.h:126)
            with self.client.lock:
                self._mapper.state = self.client.state  # pick up server
                self._mapper.step(depth, color, T_odom_cam, t)
                self.client.state = self._mapper.state
            if self.server is not None:
                self.server.time_line_update()

    # vio_interface.h:46-60 publishLoopClosure (both overloads)
    def publish_loop_closure(self, from_client: int, from_time: float,
                             to_client: int, to_time: float,
                             T_from_to: Array) -> bool:
        if self.server is None:
            return False
        return self.server.map_fusion(MapFusionMsg(
            from_client=from_client, from_time=from_time,
            to_client=to_client, to_time=to_time, T_from_to=T_from_to))

    def update_pose_matrix(self, T_cw: np.ndarray, t: float,
                           depth: Optional[Array] = None,
                           color: Optional[Array] = None,
                           orbslam_axes: bool = True) -> None:
        """updatePose(cv::Mat/Eigen::Matrix4d) overload parity
        (vio_interface.h:34-44): accepts the tracker's 4x4 camera-from-
        world matrix, optionally in ORB-SLAM axes."""
        if orbslam_axes:
            T = pose_from_orbslam(T_cw)
        else:
            T4 = np.asarray(T_cw, np.float64)
            T = geo.make(geo.matrix_to_quat(jnp.asarray(T4[:3, :3],
                                                        jnp.float32)),
                         jnp.asarray(T4[:3, 3], jnp.float32))
        self.update_pose(T, t, depth, color)

    def frames(self):
        """Current transform chain, the pull equivalent of the
        reference's 100 Hz odom→imu→sensor TF broadcast
        (tf_publisher.h:76-100): {('odom','sensor'): T} or, with IMU
        extrinsics set, {('odom','imu'): T·T_I_S⁻¹, ('imu','sensor'):
        T_I_S}."""
        if self.T_odom_latest is None:
            return {}
        T_O_S = self.T_odom_latest
        if self.T_imu_sensor is None:
            return {("odom", "sensor"): T_O_S}
        T_I_S = self.T_imu_sensor
        return {("odom", "imu"): geo.compose(T_O_S, geo.inverse(T_I_S)),
                ("imu", "sensor"): T_I_S}

    # vio_interface.h:68-80 toggleMapping service
    def toggle_mapping(self, enable: bool) -> None:
        self.mapping_enabled = enable

    # vio_interface.h:82-113 needToFuse w/ cache + updateNeedToFuse
    def need_to_fuse(self, cid_a: int, cid_b: int, t: float) -> bool:
        key = (min(cid_a, cid_b), max(cid_a, cid_b))
        if self.server is not None:
            self._need_to_fuse_cache[key] = self.server.need_to_fuse(
                cid_a, cid_b, t)
        return self._need_to_fuse_cache.get(key, True)
