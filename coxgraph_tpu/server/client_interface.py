"""Client-side serving interface — the in-process equivalent of the
reference's client services + topics (get_client_submap / get_all_submaps /
get_pose_history, coxgraph_client.cpp:38-45; time_line + map_pose_updates
topics :120-153; loop-closure input).

The server talks to every robot through this interface; an in-process
robot wraps its MapperState, a remote robot would wrap a DCN queue — the
server code is identical (SURVEY.md §5.8 two-tier fabric).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import geometry as geo
from ..core import voxel as vx
from ..mapper import submap_mapper as sm
from ..solver import pose_graph as pg

Array = jax.Array


@dataclasses.dataclass
class SubmapHandle:
    """One served submap (the ClientSubmap message equivalent:
    coxgraph_msgs/ClientSubmap.msg — layer + pose + history)."""

    client_id: int
    client_submap_id: int
    layer: vx.TsdfLayer
    T_cli_submap: np.ndarray  # submap pose in the client's odom frame (host)
    start_time: float
    end_time: float
    hist_stamps: np.ndarray   # (H,)
    hist_poses: np.ndarray    # (H,7) T_submap_cam (host numpy — server
    #                           control code composes these on the host)


class InProcessClient:
    """Wraps a robot's mapper for server access. ``state`` is rebound by
    the robot's own frame loop; the server only reads it and pushes pose
    updates / loop closures back."""

    def __init__(self, client_id: int, cfg: sm.MapperConfig,
                 state: sm.MapperState):
        self.client_id = client_id
        self.cfg = cfg
        self.state = state
        self.sent_submaps: set[int] = set()   # send-once policy
        self.bytes_sent = 0                   # bandwidth accounting
        self._published_poses: dict = {}      # csid → last-published pose
        self.mapping_enabled = True           # toggle_mapping service state
        self.finished = False                 # finish_map latched
        self.mapper = None                    # optional HostMapper to control
        # interface duality with comm.bus.RemoteClient: in-process calls
        # can't fail in transport, so this only ever reads FUTURE/SUCCESS
        # (ClientHandler ReqState, client_handler.h:106)
        self.req_state = "noninit"
        self.failures = 0
        # Deferred local PGO (streaming pipeline): with
        # defer_local_pgo, receive_loop_closure only ADDS the constraint
        # (one cheap dispatch) and marks the solve pending; the robot's
        # own frame loop runs run_pending_local_pgo() between windows.
        # Keeps a detector thread's closure floods from holding the
        # client lock through a full LM solve while the stream thread
        # waits to integrate (the reference's loop topic is likewise
        # consumed by the client's own spin, not the publisher's thread).
        self.defer_local_pgo = False
        self.local_pgo_pending = False
        # Pause lock for async server↔robot overlap (the reference
        # client's submap_proc_mutex_ timed lock, coxgraph_client.h:126):
        # server-origin state mutations (apply_pose_updates,
        # receive_loop_closure, finish_map) and submap serving take it;
        # a robot frame loop that rebinds self.state must hold it too —
        # `with client.lock: client.state = ...` — so a background PGO
        # pose push never interleaves with a frame's read-modify-write.
        self.lock = threading.RLock()

    # -- mapping control services -------------------------------------------

    def toggle_mapping(self, enable: bool) -> None:
        """Enable/disable integration — the tsdf client's toggle_mapping
        service (called by scripts/start_mapping.sh:2-5 and
        vio_interface.h:68-80). The robot's frame loop consults
        ``mapping_enabled`` before integrating."""
        self.mapping_enabled = bool(enable) and not self.finished
        if self.mapper is not None:
            self.mapper.mapping_enabled = self.mapping_enabled

    def finish_map(self) -> bool:
        """Finalize the map: run a last local pose-graph optimization over
        the submap chain and stop integrating (the voxgraph finish_map
        service each client exposes, called at finish_experiment.sh:3-4
        before the server's final mesh). Idempotent."""
        with self.lock:
            if self.finished:
                return False
            if self.mapper is not None:
                # one finalize implementation: delegate to the HostMapper
                self.mapper.finish_map()
                self.state = self.mapper.state
            elif int(self.state.collection.num_submaps) > 1:
                self.state = sm.optimize_local(self.cfg, self.state)
            self.finished = True
            self.mapping_enabled = False
            return True

    def _mirror(self):
        """The attached HostMapper's host bookkeeping mirror, when
        usable: serving timeline/handles/pose lookups from it costs ZERO
        device readbacks — on a device busy with a long solve program,
        every readback in this path would stall the fusion thread behind
        the solve. None ⇒ device path."""
        m = self.mapper
        if m is not None and getattr(m, "mirror_enabled", False) \
                and m.host_submaps:
            return m
        return None

    # -- topics the client publishes --------------------------------------

    def timeline(self) -> Tuple[float, float]:
        # under the pause lock: the robot frame loop DONATES the previous
        # state's buffers into sm.integrate, so an unlocked reader can
        # bind `state` and then np.asarray a deleted buffer (caught by
        # the async-PGO stress test: "Array has been deleted")
        with self.lock:
            m = self._mirror()
            if m is not None:
                return (m.host_submaps[0]["start"],
                        m.host_submaps[-1]["end"])
            col = self.state.collection
            n = int(col.num_submaps)  # () ready buffer — free
            if n == 0:
                return (0.0, -1.0)
            # whole-buffer transfers only: per-index eager reads compile
            # a fresh program per index (utils/hostops)
            return (float(np.asarray(col.start_time)[0]),
                    float(np.asarray(col.end_time)[n - 1]))

    def pose_update_deltas(self) -> List[Tuple[int, Array]]:
        """Submap poses changed since the last call — the client's
        map_pose_updates publication after local PGO
        (publishMapPoseUpdates, coxgraph_client.cpp:135-153 publishes only
        submaps whose pose moved)."""
        with self.lock:
            return self._pose_update_deltas_locked()

    def _pose_update_deltas_locked(self) -> List[Tuple[int, Array]]:
        m = self._mirror()
        if m is not None:
            out = []
            for k, T in enumerate(m.host_T_odom_submap):
                prev = self._published_poses.get(k)
                if prev is None or not np.allclose(prev, T, atol=1e-6):
                    out.append((k, T.copy()))
                    self._published_poses[k] = T.copy()
            return out
        col = self.state.collection
        n = int(col.num_submaps)
        if n == 0:
            return []
        T = np.asarray(col.T_odom_submap)[:n]
        out = []
        for k in range(n):
            prev = self._published_poses.get(k)
            if prev is None or not np.allclose(prev, T[k], atol=1e-6):
                # host numpy out: the server consumes these on the host
                out.append((k, T[k].copy()))
                self._published_poses[k] = T[k].copy()
        return out

    # -- services ----------------------------------------------------------

    def _submap_index_at(self, t: float) -> Optional[int]:
        m = self._mirror()
        if m is not None:
            for k, rec in enumerate(m.host_submaps):
                if rec["start"] - 1e-6 <= t <= rec["end"] + 1e-6:
                    return k
            return None
        col = self.state.collection
        n = int(col.num_submaps)
        start = np.asarray(col.start_time)
        end = np.asarray(col.end_time)
        for k in range(n):
            if start[k] - 1e-6 <= t <= end[k] + 1e-6:
                return k
        return None

    def _handle(self, k: int) -> SubmapHandle:
        col = self.state.collection
        layer = sm._get_layer(col.layers, jnp.asarray(k))
        if k not in self.sent_submaps:
            self.sent_submaps.add(k)
            self.bytes_sent += vx.memory_size_bytes(layer)
        m = self._mirror()
        if m is not None and k < len(m.host_submaps):
            # mirror-backed handle: only the layer slice touches the
            # device (a lazy dispatch, no readback)
            rec = m.host_submaps[k]
            return SubmapHandle(
                client_id=self.client_id, client_submap_id=k, layer=layer,
                T_cli_submap=m.host_T_odom_submap[k].copy(),
                start_time=rec["start"], end_time=rec["end"],
                hist_stamps=np.asarray(rec["stamps"]),
                hist_poses=(np.stack(rec["poses"]).astype(np.float32)
                            if rec["poses"]
                            else np.zeros((0, 7), np.float32)))
        h = int(np.asarray(col.hist_count)[k])
        start = np.asarray(col.start_time)
        end = np.asarray(col.end_time)
        return SubmapHandle(
            client_id=self.client_id,
            client_submap_id=k,
            layer=layer,
            # poses stay HOST numpy: the server's control plane is host
            # math (ServerSubmap docstring); re-uploading here just to
            # re-download server-side would cost two transfers
            T_cli_submap=np.asarray(col.T_odom_submap)[k],
            start_time=float(start[k]),
            end_time=float(end[k]),
            hist_stamps=np.asarray(col.hist_stamps)[k, :h],
            hist_poses=np.asarray(col.hist_poses)[k, :h],
        )

    def get_submap_by_time(self, t: float) -> Optional[SubmapHandle]:
        """None ⇒ t is ahead of this client's timeline ('future' fusion,
        reference ReqState::FUTURE, client_handler.h:106)."""
        with self.lock:
            k = self._submap_index_at(t)
            self.req_state = "future" if k is None else "success"
            return None if k is None else self._handle(k)

    def get_all_submaps(self) -> List[SubmapHandle]:
        # holding the pause lock = the reference client pausing submap
        # processing while it serializes everything for the server
        # (getAllClientSubmapsCallback + submap_proc_mutex_,
        # coxgraph_client.cpp:83-106)
        with self.lock:
            m = self._mirror()
            n = (len(m.host_submaps) if m is not None
                 else int(self.state.collection.num_submaps))
            return [self._handle(k) for k in range(n)]

    def get_pose_history(self):
        """Full odom-frame trajectory (stamps, poses) — the client's
        get_pose_history service (coxgraph_client.cpp:38-45, pulled by
        ClientHandler::requestPoseHistory, client_handler.cpp:149-160)."""
        with self.lock:
            m = self._mirror()
            if m is not None:
                ss, ps = [], []
                for k, rec in enumerate(m.host_submaps):
                    if not rec["stamps"]:
                        continue
                    T = m.host_T_odom_submap[k]
                    ss.append(np.asarray(rec["stamps"]))
                    ps.append(geo.compose_np(T[None, :],
                                             np.stack(rec["poses"])))
                if not ss:
                    return np.zeros((0,)), np.zeros((0, 7))
                return np.concatenate(ss), np.concatenate(ps)
            return sm.trajectory(self.state.collection)

    def lookup_pose_in_submap(self, k: int, t: float) -> np.ndarray:
        """T_submap_cam at time t from the submap's history
        (voxgraph lookupPoseByTime, used at coxgraph_client.cpp:53-57).
        Interpolates on the host (whole-buffer transfers only); returns
        HOST numpy — consumers are host control code."""
        with self.lock:
            m = self._mirror()
            if m is not None and k < len(m.host_submaps) \
                    and m.host_submaps[k]["stamps"]:
                rec = m.host_submaps[k]
                return np.asarray(geo.lookup_pose_np(
                    np.asarray(rec["stamps"]), np.stack(rec["poses"]), t))
            col = self.state.collection
            h = int(np.asarray(col.hist_count)[k])
            stamps = np.asarray(col.hist_stamps)[k, :h]
            poses = np.asarray(col.hist_poses)[k, :h]
        return np.asarray(geo.lookup_pose_np(stamps, poses, t))

    # -- server → client ----------------------------------------------------

    def receive_loop_closure(self, t_a: float, t_b: float, T_ta_tb: Array,
                             sqrt_info: Optional[Array] = None) -> bool:
        """Intra-client loop closure forwarded by the server
        (ClientHandler::pubLoopClosureMsg path, coxgraph_server.cpp:217-222).
        Converts time-stamped poses to a submap-level constraint."""
        with self.lock:
            ka = self._submap_index_at(t_a)
            kb = self._submap_index_at(t_b)
            if ka is None or kb is None or ka == kb:
                return False
            T_sa_ta = self.lookup_pose_in_submap(ka, t_a)
            T_sb_tb = self.lookup_pose_in_submap(kb, t_b)
            T_sa_sb = geo.compose(
                geo.compose(T_sa_ta, T_ta_tb), geo.inverse(T_sb_tb))
            self.state = sm.add_loop_closure(self.state, ka, kb, T_sa_sb,
                                             sqrt_info)
            if self.defer_local_pgo:
                self.local_pgo_pending = True
            else:
                self.state = sm.optimize_local(self.cfg, self.state)
                if self.mapper is not None:
                    self.mapper.refresh_pose_mirror(state=self.state)
            return True

    def run_pending_local_pgo(self) -> bool:
        """Run the deferred local solve if closures accumulated since the
        last call (see defer_local_pgo). → True if a solve ran. Callers
        sharing state with a HostMapper must rebind it afterwards."""
        with self.lock:
            if not self.local_pgo_pending:
                return False
            self.local_pgo_pending = False
            self.state = sm.optimize_local(self.cfg, self.state)
            if self.mapper is not None:
                self.mapper.refresh_pose_mirror(state=self.state)
            return True

    def apply_pose_updates(self, updates: List[Tuple[int, Array]]) -> None:
        """Server-optimized submap poses pushed back
        (MapPoseUpdates topic, client_handler.cpp:106-129). Runs under the
        pause lock: with async PGO this arrives from the server's solve
        thread while the robot's frame loop owns ``state``."""
        with self.lock:
            col = self.state.collection
            m = self._mirror()
            if m is not None:
                # rebuild the pose table from the host mirror — a device
                # readback here runs on the SOLVE thread while holding
                # the client lock, stalling the stream thread behind
                # whatever program is in flight
                S = col.T_odom_submap.shape[0]
                T = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32),
                            (S, 1))
                for k, Tk in enumerate(m.host_T_odom_submap):
                    T[k] = Tk
            else:
                T = np.asarray(col.T_odom_submap).copy()
            for k, pose in updates:
                T[k] = np.asarray(pose)
                # don't echo server-pushed poses back as client updates
                self._published_poses[int(k)] = T[k].copy()
            self.state = dataclasses.replace(
                self.state,
                collection=dataclasses.replace(col,
                                               T_odom_submap=jnp.asarray(T)))
            if self.mapper is not None:
                # mirror the push (host values — free)
                self.mapper.apply_pose_updates_host(updates)
