"""Per-robot submap mapper — the client frontend. Replaces
voxgraph::VoxgraphMapper + cblox submap collections + the client MapServer
(reference: CoxgraphClient ⊂ VoxgraphMapper, coxgraph_client.h:33-70;
submap interval semantics from coxgraph_client.yaml
``submap_creation_interval: 10``; merged-map publishing from
map_server.cpp:59-117).

Design: a SubmapCollection is ONE pytree whose leaves carry a leading
submap axis (S, ...), so the whole mapper state jits, donates, shards, and
checkpoints as plain arrays. A submap = posed TSDF layer + time interval +
in-submap pose history (cblox TsdfEsdfSubmap + voxgraph VoxgraphSubmap
capability, SURVEY.md §2.9). Frame integration is a pure jitted step;
submap rollover is a separate jitted transition triggered by the host (the
timeline check is host-driven in the reference too — its submapCallback).

Pose histories are stored **in the submap frame**, so a pose-graph update
that moves T_odom_submap re-poses the whole trajectory segment for free —
this is how the reference ships submaps once and patches poses afterwards
(coxgraph_client.cpp:60-66, 135-153).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..core import geometry as geo
from ..core import voxel as vx
from ..frontends.synthetic import PinholeIntrinsics
from ..ops import merge as merge_ops
from ..ops import points as points_ops
from ..ops import tsdf as tsdf_ops
from ..solver import pose_graph as pg

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    """Static mapper parameters (reference operating points in
    BASELINE.md)."""

    spec: vx.VoxelGridSpec = vx.VoxelGridSpec()
    integrator: tsdf_ops.TsdfIntegratorConfig = tsdf_ops.TsdfIntegratorConfig()
    intrinsics: PinholeIntrinsics = PinholeIntrinsics()
    max_submaps: int = 32
    max_history: int = 512            # poses per submap history
    submap_interval: float = 10.0     # s (coxgraph_client.yaml:5)
    max_constraints: int = 256
    odom_sqrt_info: float = 20.0      # odometry constraint confidence
    # solver settings for the LOCAL pose-graph solve (optimize_local /
    # receive_loop_closure) — set huber_delta > 0 to robustify against
    # outlier loop closures from real-sensor feature matching (the
    # reference wraps its Ceres loop costs in robust kernels the same
    # way); explicit solver_cfg arguments override
    local_solver: "pg.SolverConfig" = None
    # Absolute height priors on submap poses (odom z at submap creation;
    # gravity-aligned VIO makes it an absolute measurement). 0 = off.
    # Purely relative chain+loop constraints admit a pitch+z drift
    # valley the LOCAL solve can escape into exactly like the global one
    # (observed on the tum_loop drift test: loop
    # closures "satisfied" by sagging the loop interior 0.36 m out of
    # plane). Mirrors ServerConfig.height_prior_stddev.
    height_prior_stddev: float = 0.0
    # pointcloud-input path ("merged" integrator, ops/points.py) — None
    # derives a default from the frame integrator's block budget
    point_integrator: Optional["points_ops.PointIntegratorConfig"] = None


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SubmapCollection:
    """Stacked submaps: every TsdfLayer leaf gains a leading (S,) axis."""

    layers: vx.TsdfLayer              # leaves (S, ...)
    T_odom_submap: Array              # (S,7) — optimized by PGO
    start_time: Array                 # (S,)
    end_time: Array                   # (S,)
    hist_stamps: Array                # (S,H)
    hist_poses: Array                 # (S,H,7) T_submap_cam
    hist_count: Array                 # (S,) int32
    num_submaps: Array                # () int32

    @property
    def active(self) -> Array:
        return jnp.maximum(self.num_submaps - 1, 0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MapperState:
    collection: SubmapCollection
    constraints: pg.RelPoseConstraints   # local pose graph (odometry + loops)
    heights: pg.HeightConstraints        # absolute z priors (one/submap
    #                                      when cfg.height_prior_stddev>0)
    frame_count: Array                   # () int32
    # per-submap updated-block bits — the voxblox Block::updated(mesh)
    # flag the reference MeshIntegrator consumes to re-mesh only changed
    # blocks (map_server.cpp:119-152): integrators OR in the slots whose
    # voxel data they wrote; IncrementalMesher consumes + clears a row
    # via consume_mesh_dirty (64 KB at stock config — free to carry)
    mesh_dirty: Array                    # (S, max_blocks) bool


def create_collection(cfg: MapperConfig) -> SubmapCollection:
    S, H = cfg.max_submaps, cfg.max_history
    empty = vx.create_tsdf_layer(cfg.spec)
    layers = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (S,) + x.shape).copy(), empty
    )
    return SubmapCollection(
        layers=layers,
        T_odom_submap=jnp.tile(geo.identity()[None], (S, 1)),
        start_time=jnp.zeros((S,)),
        end_time=jnp.zeros((S,)),
        hist_stamps=jnp.zeros((S, H)),
        hist_poses=jnp.tile(geo.identity()[None, None], (S, H, 1)),
        hist_count=jnp.zeros((S,), jnp.int32),
        num_submaps=jnp.zeros((), jnp.int32),
    )


def create_mapper(cfg: MapperConfig) -> MapperState:
    return MapperState(
        collection=create_collection(cfg),
        constraints=pg.RelPoseConstraints.empty(cfg.max_constraints),
        heights=pg.HeightConstraints.empty(cfg.max_submaps),
        frame_count=jnp.zeros((), jnp.int32),
        mesh_dirty=jnp.zeros((cfg.max_submaps, cfg.spec.max_blocks),
                             jnp.bool_),
    )


def _get_layer(layers: vx.TsdfLayer, k: Array) -> vx.TsdfLayer:
    return jax.tree.map(
        lambda x: jax.lax.dynamic_index_in_dim(x, k, 0, keepdims=False), layers
    )


get_layer = jax.jit(_get_layer)
get_layer.__doc__ = ("Jitted submap-layer slice (one dispatch — eager "
                     "_get_layer issues one per leaf; use this from host "
                     "control loops).")


def _set_layer(layers: vx.TsdfLayer, k: Array,
               layer: vx.TsdfLayer) -> vx.TsdfLayer:
    return jax.tree.map(
        lambda x, y: jax.lax.dynamic_update_index_in_dim(x, y, k, 0),
        layers, layer,
    )


@partial(jax.jit, static_argnums=0, donate_argnums=1)
def start_submap(cfg: MapperConfig, state: MapperState, T_odom_cam: Array,
                 t: Array) -> MapperState:
    """Open a new submap anchored at the current odometry pose, and chain an
    odometry constraint from the previous submap (the voxgraph submap
    chain; reference adds one relative constraint per consecutive submap
    pair — updateSubmapRPConstraints, pose_graph_interface.cpp:51-71)."""
    col = state.collection
    k = col.num_submaps  # new slot
    prev = jnp.maximum(k - 1, 0)
    T_prev_new = geo.relative(col.T_odom_submap[prev], T_odom_cam)

    col = dataclasses.replace(
        col,
        T_odom_submap=col.T_odom_submap.at[k].set(T_odom_cam, mode="drop"),
        start_time=col.start_time.at[k].set(t, mode="drop"),
        end_time=col.end_time.at[k].set(t, mode="drop"),
        hist_count=col.hist_count.at[k].set(0, mode="drop"),
        num_submaps=jnp.minimum(k + 1, cfg.max_submaps),
    )
    # When the submap pool is saturated (k == max_submaps) the slot
    # writes above all drop — the constraint adds must drop too, or a
    # chain/height row lands with node index k that jit gather clamping
    # silently applies to the LAST REAL submap in optimize_local
    # (ADVICE r3).
    in_pool = k < cfg.max_submaps
    constraints = jax.lax.cond(
        (k > 0) & in_pool,
        lambda c: c.add(prev, k, T_prev_new,
                        cfg.odom_sqrt_info * jnp.eye(6)),
        lambda c: c,
        state.constraints,
    )
    heights = state.heights
    if cfg.height_prior_stddev > 0:
        # odom z at creation as an absolute height measurement (mirrors
        # the server wiring; pins the local pitch+z drift valley)
        heights = jax.lax.cond(
            in_pool,
            lambda h: h.add(k, T_odom_cam[6], cfg.height_prior_stddev),
            lambda h: h,
            heights,
        )
    return dataclasses.replace(state, collection=col,
                               constraints=constraints, heights=heights)


def integrate_impl(cfg: MapperConfig, state: MapperState, depth: Array,
                   color: Optional[Array], T_odom_cam: Array,
                   t: Array) -> MapperState:
    """Integrate one RGB-D frame into the active submap and append to its
    pose history (reference hot path 3.2). Uses the stacked-pool
    integrator — the per-frame cost touches only the updated blocks, not
    the full submap stack (see integrate_frame_stacked_impl)."""
    col = state.collection
    k = col.active
    T_sm_cam = geo.relative(col.T_odom_submap[k], T_odom_cam)

    layers, touched = tsdf_ops.integrate_frame_stacked_impl(
        cfg.spec, cfg.integrator, cfg.intrinsics, col.layers, k, depth,
        color, T_sm_cam, return_stats=True
    )

    h = jnp.minimum(col.hist_count[k], cfg.max_history - 1)
    col = dataclasses.replace(
        col,
        layers=layers,
        end_time=col.end_time.at[k].set(t, mode="drop"),
        hist_stamps=col.hist_stamps.at[k, h].set(t, mode="drop"),
        hist_poses=col.hist_poses.at[k, h].set(T_sm_cam, mode="drop"),
        hist_count=col.hist_count.at[k].set(h + 1, mode="drop"),
    )
    return dataclasses.replace(
        state, collection=col, frame_count=state.frame_count + 1,
        mesh_dirty=state.mesh_dirty.at[k].set(state.mesh_dirty[k] | touched),
    )


integrate = partial(jax.jit, static_argnums=0, donate_argnums=1)(
    integrate_impl)
integrate.__doc__ = "Jitted integrate_impl."


@partial(jax.jit, static_argnums=0, donate_argnums=1)
def integrate_batch(cfg: MapperConfig, state: MapperState, depths: Array,
                    colors: Optional[Array], T_odom_cams: Array,
                    ts: Array) -> MapperState:
    """Integrate a window of F frames into the CURRENT active submap in a
    single dispatch, with the result of F sequential integrate() calls.
    Submap rollover must be handled by the caller between windows
    (HostMapper splits windows at rollover times, which it knows
    host-side). The voxel work is tsdf_ops.integrate_window_stacked_impl;
    the small per-frame bookkeeping (histories, timestamps) is a scan."""
    col = state.collection
    k = col.active
    T_sm_cams = jax.vmap(
        lambda T: geo.relative(col.T_odom_submap[k], T))(T_odom_cams)
    layers, touched = tsdf_ops.integrate_window_stacked_impl(
        cfg.spec, cfg.integrator, cfg.intrinsics, col.layers, k, depths,
        colors, T_sm_cams, return_stats=True)
    col = dataclasses.replace(col, layers=layers)

    # per-frame bookkeeping (small arrays): identical to F sequential
    # integrate() calls, including the saturating history append
    def body(c_, fr):
        T_sm, t = fr
        h = jnp.minimum(c_.hist_count[k], cfg.max_history - 1)
        return dataclasses.replace(
            c_,
            end_time=c_.end_time.at[k].set(t, mode="drop"),
            hist_stamps=c_.hist_stamps.at[k, h].set(t, mode="drop"),
            hist_poses=c_.hist_poses.at[k, h].set(T_sm, mode="drop"),
            hist_count=c_.hist_count.at[k].set(h + 1, mode="drop"),
        ), None

    col, _ = jax.lax.scan(body, col, (T_sm_cams, ts))
    return dataclasses.replace(
        state, collection=col,
        frame_count=state.frame_count + depths.shape[0],
        mesh_dirty=state.mesh_dirty.at[k].set(state.mesh_dirty[k] | touched))


def _point_cfg(cfg: MapperConfig) -> "points_ops.PointIntegratorConfig":
    if cfg.point_integrator is not None:
        return cfg.point_integrator
    return points_ops.PointIntegratorConfig(
        max_range=cfg.integrator.max_range,
        min_range=cfg.integrator.min_range,
        max_weight=cfg.integrator.max_weight,
        max_touched_blocks=cfg.integrator.max_touched_blocks,
        use_distance_weight=cfg.integrator.use_distance_weight,
        use_dropoff=cfg.integrator.use_dropoff)


def integrate_points_impl(cfg: MapperConfig, state: MapperState,
                          points: Array, colors: Optional[Array],
                          valid: Array, T_odom_sensor: Array,
                          t: Array) -> MapperState:
    """Integrate one unordered pointcloud into the active submap — the
    reference client's native ``pointcloud``-topic input (voxblox
    tsdf_server integratePointCloud, SURVEY.md §3.2; the voxblox
    merged/simple pointcloud-integrator family, ops/points.py
    docstring). Mirror of integrate_impl for cloud sensors
    (lidar, recovered mesh points): same history append, same stacked
    flat-pool discipline (ops/points.py)."""
    col = state.collection
    k = col.active
    T_sm_sensor = geo.relative(col.T_odom_submap[k], T_odom_sensor)

    layers, touched = points_ops.integrate_points_stacked_impl(
        cfg.spec, _point_cfg(cfg), col.layers, k, points, colors, valid,
        T_sm_sensor, return_stats=True)

    h = jnp.minimum(col.hist_count[k], cfg.max_history - 1)
    col = dataclasses.replace(
        col,
        layers=layers,
        end_time=col.end_time.at[k].set(t, mode="drop"),
        hist_stamps=col.hist_stamps.at[k, h].set(t, mode="drop"),
        hist_poses=col.hist_poses.at[k, h].set(T_sm_sensor, mode="drop"),
        hist_count=col.hist_count.at[k].set(h + 1, mode="drop"),
    )
    return dataclasses.replace(
        state, collection=col, frame_count=state.frame_count + 1,
        mesh_dirty=state.mesh_dirty.at[k].set(state.mesh_dirty[k] | touched),
    )


integrate_points = partial(jax.jit, static_argnums=0, donate_argnums=1)(
    integrate_points_impl)
integrate_points.__doc__ = "Jitted integrate_points_impl."


@partial(jax.jit, donate_argnums=0)
def consume_mesh_dirty(state: MapperState,
                       k: Array) -> Tuple[Array, MapperState]:
    """Pop submap ``k``'s updated-block bitmap → ((max_blocks,) bool,
    state with the row cleared). One dispatch — the incremental mesher's
    per-update entry point (the reference clears Block::updated(mesh) as
    the MeshIntegrator consumes it)."""
    row = state.mesh_dirty[k]
    return row, dataclasses.replace(
        state, mesh_dirty=state.mesh_dirty.at[k].set(False))


def mapper_step(cfg: MapperConfig, state: MapperState, depth: Array,
                color: Optional[Array], T_odom_cam: Array,
                t: float) -> Tuple[MapperState, bool]:
    """Host-orchestrated step: roll the submap if the interval elapsed,
    then integrate. Returns (state, new_submap_started)."""
    import numpy as np

    col = state.collection
    n = int(col.num_submaps)
    started = False
    if n == 0 or (float(t) - float(np.asarray(col.start_time)[n - 1])
                  >= cfg.submap_interval - 1e-6):
        state = start_submap(cfg, state, T_odom_cam, jnp.asarray(t, jnp.float32))
        started = True
    state = integrate(cfg, state, depth, color, T_odom_cam,
                      jnp.asarray(t, jnp.float32))
    return state, started


class HostMapper:
    """Host-side wrapper that mirrors the rollover scalars (submap count,
    active start time) so the per-frame hot loop issues ZERO device→host
    reads, each of which would wait for the device to drain."""

    def __init__(self, cfg: MapperConfig, state: Optional[MapperState] = None):
        self.cfg = cfg
        self.state = state if state is not None else create_mapper(cfg)
        self.n_submaps = int(self.state.collection.num_submaps)
        self.last_start = (
            float(self.state.collection.start_time[self.n_submaps - 1])
            if self.n_submaps else 0.0)
        # toggle_mapping service state (start_mapping.sh:2-5); frames
        # arriving while disabled are dropped, as the reference tsdf
        # client does.
        self.mapping_enabled = True
        # rollovers refused because the submap pool was full — frames
        # keep integrating into the LAST submap (warn-and-count like the
        # constraint pools; the reference grows its collection
        # dynamically, submap_collection.cpp:10-22)
        self.dropped_submaps = 0
        # incremental per-submap meshers (VERDICT r3 Missing #1): lazily
        # created by live_mesh(); dirty bits live in state.mesh_dirty
        self._meshers: dict = {}
        # HOST mirror of which submaps integrated anything since their
        # last live_mesh: live_mesh_odom skips clean cached submaps
        # without touching the device (polling every finished submap's
        # dirty bitmap costs 2 dispatches + a readback EACH per update)
        self._touched_submaps: set = set()
        # odom-frame transformed-soup cache per submap (pose, verts,
        # cols): clean submaps at an unchanged pose skip the host
        # re-transform too (transform_points_np over a many-submap
        # union is the bulk of an update's host math)
        self._odom_soup_cache: dict = {}
        # HOST MIRROR of the client-serving bookkeeping (timeline,
        # submap-frame pose histories, submap poses): step() inputs are
        # host data, so the mirror costs only host math to maintain, and
        # InProcessClient serves timeline/handles/pose lookups with ZERO
        # device readbacks — on a device busy with a long solve, every
        # such readback would stall the fusion path behind the solve.
        # Device-side pose changes
        # (optimize_local) refresh it with ONE whole-buffer readback.
        # only valid when the mirror observed EVERY submap from creation:
        # a mapper wrapped around pre-existing state (checkpoint restore)
        # can't reconstruct histories, so it serves from the device
        self.mirror_enabled = self.n_submaps == 0
        self.host_T_odom_submap: list = []     # per-submap np (7,)
        self.host_submaps: list = []           # {start,end,stamps,poses}

    # -- host mirror maintenance (see __init__ mirror_enabled) ----------

    def _mirror_host_pose(self, T_odom_cam):
        """np view of a pose input, or None after DISABLING the mirror:
        device-array poses would cost a readback per frame to mirror —
        callers wanting mirror-backed serving pass host poses (streaming
        loops do); others gracefully fall back to the device path."""
        import numpy as np

        if isinstance(T_odom_cam, np.ndarray):
            return T_odom_cam
        if self.mirror_enabled:
            self.mirror_enabled = False
            self.host_submaps.clear()
            self.host_T_odom_submap.clear()
        return None

    def _mirror_start(self, T_odom_cam, t: float) -> None:
        if not self.mirror_enabled:
            return
        import numpy as np

        T = self._mirror_host_pose(T_odom_cam)
        if T is None:
            return
        self.host_T_odom_submap.append(np.asarray(T, np.float32).copy())
        self.host_submaps.append({"start": float(t), "end": float(t),
                                  "stamps": [], "poses": []})

    def _mirror_frame(self, T_odom_cam, t: float) -> None:
        if not self.mirror_enabled or not self.host_submaps:
            return
        import numpy as np

        T_odom_cam = self._mirror_host_pose(T_odom_cam)
        if T_odom_cam is None:
            return
        k = len(self.host_submaps) - 1
        rec = self.host_submaps[k]
        T_sm_cam = geo.relative_np(self.host_T_odom_submap[k],
                                   np.asarray(T_odom_cam, np.float32))
        if len(rec["stamps"]) >= self.cfg.max_history:
            # saturating append — mirrors the device h-clamp exactly
            rec["stamps"][-1] = float(t)
            rec["poses"][-1] = T_sm_cam
        else:
            rec["stamps"].append(float(t))
            rec["poses"].append(T_sm_cam)
        rec["end"] = float(t)

    def refresh_pose_mirror(self, state: Optional[MapperState] = None
                            ) -> None:
        """Re-read submap poses after a DEVICE-side pose change
        (optimize_local / forwarded loop closures) — ONE whole-buffer
        readback of (S,7). ``state`` overrides self.state for callers
        holding the authoritative alias (InProcessClient)."""
        if not self.mirror_enabled:
            return
        import numpy as np

        col = (state or self.state).collection
        T = np.asarray(col.T_odom_submap)
        for k in range(min(len(self.host_T_odom_submap), T.shape[0])):
            self.host_T_odom_submap[k] = T[k].copy()

    def apply_pose_updates_host(self, updates) -> None:
        """Mirror server-pushed pose updates (host values — free)."""
        if not self.mirror_enabled:
            return
        import numpy as np

        for k, T in updates:
            if int(k) < len(self.host_T_odom_submap):
                self.host_T_odom_submap[int(k)] = \
                    np.asarray(T, np.float32).copy()

    def _rollover_sat(self, n: Optional[int] = None) -> bool:
        """True (+warn/count) when a due rollover cannot start a new
        submap because the pool is saturated. ``n`` overrides the live
        submap count (step_batch tracks it locally within a window)."""
        if (self.n_submaps if n is None else n) < self.cfg.max_submaps:
            return False
        import warnings

        self.dropped_submaps += 1
        warnings.warn(
            f"submap pool saturated ({self.cfg.max_submaps}); rollover "
            f"dropped (total {self.dropped_submaps}) — frames continue "
            f"into the last submap; raise MapperConfig.max_submaps",
            RuntimeWarning, stacklevel=3)
        return True

    _MESHER_KWARGS = ("chunk", "min_weight", "max_tris", "quantize")

    def live_mesher(self, k: int, **kwargs):
        """The incremental mesher bound to submap ``k`` (created on first
        use; kwargs forwarded to IncrementalMesher on creation). Config
        kwargs that CONFLICT with an existing mesher raise — silently
        returning, say, quantized cached geometry to a quantize=False
        caller would be a wrong-data bug (ADVICE r4). A kwargs-free call
        accepts whatever mesher exists (documented: settings are fixed
        at creation); unknown kwarg names raise instead of being
        swallowed by the comparison."""
        from ..ops.mesh_incremental import IncrementalMesher

        unknown = set(kwargs) - set(self._MESHER_KWARGS)
        if unknown:
            raise TypeError(f"live_mesher: unknown kwargs {sorted(unknown)}")
        m = self._meshers.get(k)
        if m is None:
            m = IncrementalMesher(self.cfg.spec, **kwargs)
            self._meshers[k] = m
        else:
            for key, val in kwargs.items():
                if key == "max_tris":   # buffer size may auto-grow
                    continue
                if getattr(m, key) != val:
                    raise ValueError(
                        f"live_mesher({k}) already exists with "
                        f"{key}={getattr(m, key)!r}; requested {val!r} — "
                        "per-submap mesher settings are fixed at creation")
        return m

    def live_mesh(self, k: Optional[int] = None, **kwargs):
        """Up-to-date triangle soup of submap ``k`` (default: active), in
        the SUBMAP frame, re-meshing only the blocks updated since the
        last call (state.mesh_dirty → dirty chunks → one
        extract_mesh_chunks_device dispatch). The frame-rate mesh
        streaming path (reference publishSubmapMesh cadence,
        map_server.cpp:119-152) — cost scales with changed geometry, not
        map size. → (verts (T,3,3), colors (T,3,3)) f32 numpy.

        DONATES the mapper state (like step/step_batch): any external
        alias of ``self.state`` — e.g. an InProcessClient sharing it
        with an async-PGO server — must call this under that client's
        lock and rebind ``client.state = mapper.state`` afterwards, or
        the alias points at deleted buffers."""
        return self.live_mesh_async(k, **kwargs)()

    def live_mesh_async(self, k: Optional[int] = None, **kwargs):
        """Lock-held half of :meth:`live_mesh` for PIPELINED serving:
        consume submap ``k``'s dirty bits and capture a fresh layer
        slice, then return a zero-arg ``finish()`` that performs the
        chunk extraction dispatch + host readback — to be called OFF
        the owning client's lock, so mesh readbacks (which queue behind
        any in-flight solve on the device) never stall
        the integration thread. The reference serves meshes from a
        separate map_server node for exactly this reason
        (map_server.cpp:77-152: publishing must not block integration).

        Safety: ``get_layer`` is a jitted gather whose output buffers
        are INDEPENDENT of the mapper state, so they survive later
        state donations by step/step_batch. Contract: call this method
        under the client's lock and rebind ``client.state`` before
        releasing it; call ``finish()`` from ONE serving thread only
        (the per-submap mesher caches are unlocked)."""
        if k is None:
            k = max(self.n_submaps - 1, 0)
        row, self.state = consume_mesh_dirty(self.state,
                                             jnp.asarray(k, jnp.int32))
        mesher = self.live_mesher(k, **kwargs)
        layer = get_layer(self.state.collection.layers,
                          jnp.asarray(k, jnp.int32))
        self._touched_submaps.discard(k)

        def finish():
            mesher.update(layer, row)
            return mesher.mesh()

        return finish

    def live_mesh_odom(self, **kwargs):
        """All submaps' cached live meshes concatenated in the ODOM frame
        (one incremental update per submap; finished submaps cost only
        the dirty-bit check). → (verts (T,3,3), colors (T,3,3))."""
        from ..core import geometry as geo
        import numpy as np

        n = max(self.n_submaps, 1) if self.n_submaps else 0
        poses = np.asarray(self.state.collection.T_odom_submap)
        vs, cs = [], []
        for k in range(n):
            clean = k in self._meshers and k not in self._touched_submaps
            cached = self._odom_soup_cache.get(k)
            if clean and cached is not None \
                    and np.array_equal(cached[0], poses[k]):
                # unchanged geometry at an unchanged pose: reuse the
                # transformed soup outright (zero device AND host work)
                vs.append(cached[1])
                cs.append(cached[2])
                continue
            if clean:
                # geometry current, pose moved: cached soup, re-transform
                # (live_mesher() validates kwargs against the cache)
                v, c = self.live_mesher(k, **kwargs).mesh()
            else:
                v, c = self.live_mesh(k, **kwargs)
            if v.shape[0] == 0:
                self._odom_soup_cache.pop(k, None)
                continue
            vw = geo.transform_points_np(
                poses[k], v.reshape(-1, 3)).reshape(-1, 3, 3)
            vw = vw.astype(np.float32)
            self._odom_soup_cache[k] = (poses[k].copy(), vw, c)
            vs.append(vw)
            cs.append(c)
        if not vs:
            z = np.zeros((0, 3, 3), np.float32)
            return z, z.copy()
        return np.concatenate(vs), np.concatenate(cs)

    def finish_map(self,
                   solver_cfg: "pg.SolverConfig" = None) -> None:
        """Final local PGO + stop integrating (the voxgraph finish_map
        service, finish_experiment.sh:3-4)."""
        if self.n_submaps > 1:
            self.state = optimize_local(self.cfg, self.state, solver_cfg)
            self.refresh_pose_mirror()
        self.mapping_enabled = False

    def step(self, depth: Array, color: Optional[Array], T_odom_cam: Array,
             t: float) -> bool:
        if not self.mapping_enabled:
            return False
        started = False
        if (self.n_submaps == 0
                or t - self.last_start >= self.cfg.submap_interval - 1e-6):
            if self._rollover_sat():
                self.last_start = t
            else:
                self.state = start_submap(self.cfg, self.state, T_odom_cam,
                                          jnp.asarray(t, jnp.float32))
                self.n_submaps += 1
                self.last_start = t
                started = True
                self._mirror_start(T_odom_cam, t)
        self.state = integrate(self.cfg, self.state, depth, color,
                               T_odom_cam, jnp.asarray(t, jnp.float32))
        self._mirror_frame(T_odom_cam, t)
        self._touched_submaps.add(max(self.n_submaps - 1, 0))
        return started

    def step_points(self, points: Array, colors: Optional[Array],
                    valid: Array, T_odom_sensor: Array, t: float) -> bool:
        """Pointcloud-sensor step (lidar / recovered clouds): same
        rollover logic as step(), integration via ops/points.py. Callers
        should pad clouds to a fixed capacity (power-of-two buckets) so
        the jit cache stays bounded."""
        if not self.mapping_enabled:
            return False
        started = False
        if (self.n_submaps == 0
                or t - self.last_start >= self.cfg.submap_interval - 1e-6):
            if self._rollover_sat():
                self.last_start = t
            else:
                self.state = start_submap(self.cfg, self.state,
                                          T_odom_sensor,
                                          jnp.asarray(t, jnp.float32))
                self.n_submaps += 1
                self.last_start = t
                started = True
                self._mirror_start(T_odom_sensor, t)
        self.state = integrate_points(self.cfg, self.state, points, colors,
                                      valid, T_odom_sensor,
                                      jnp.asarray(t, jnp.float32))
        self._mirror_frame(T_odom_sensor, t)
        self._touched_submaps.add(max(self.n_submaps - 1, 0))
        return started

    def step_batch(self, depths: Array, colors: Optional[Array],
                   T_odom_cams: Array, ts) -> int:
        """Process a window of F frames with at most #rollovers+1 device
        dispatches: rollover boundaries are computed host-side from the
        timestamps (no device sync), and the frames between boundaries go
        through one integrate_batch scan each. Bit-identical to F step()
        calls. Returns the number of submaps started."""
        import numpy as np

        if not self.mapping_enabled:
            return 0
        # poses for the mirror — host arrays only (a device input
        # disables the mirror rather than paying a readback per window)
        T_host = (self._mirror_host_pose(T_odom_cams)
                  if self.mirror_enabled else None)
        # rollover bookkeeping in FLOAT64: an f32 downcast loses ~4 µs
        # of resolution per minute of mission time, so `t - last_start >=
        # interval - 1e-6` starts failing at exact window boundaries a
        # few minutes in — the rollover then fires ONE FRAME LATE and
        # splits the window into odd-length segments, each a fresh
        # compile (the device still gets f32 stamps via jnp.asarray below)
        ts = np.asarray(ts, np.float64)
        F = len(ts)
        starts = []          # frame indices where a rollover fires
        last = self.last_start
        n = self.n_submaps
        for i in range(F):
            if n == 0 or ts[i] - last >= self.cfg.submap_interval - 1e-6:
                last = float(ts[i])
                if self._rollover_sat(n):   # warn+count; frames continue
                    pass                    # into the last submap
                else:
                    starts.append(i)
                    n += 1
        segments = []        # (rollover frame or None, lo, hi)
        if not starts or starts[0] > 0:
            segments.append((None, 0, starts[0] if starts else F))
        bounds = starts + [F]
        for b, e in zip(bounds[:-1], bounds[1:]):
            segments.append((b, b, e))
        for start_i, lo, hi in segments:
            if start_i is not None:
                self.state = start_submap(
                    self.cfg, self.state, T_odom_cams[start_i],
                    jnp.asarray(float(ts[start_i]), jnp.float32))
                self.n_submaps = min(self.n_submaps + 1,
                                     self.cfg.max_submaps)
                self.last_start = float(ts[start_i])
                if T_host is not None:
                    self._mirror_start(T_host[start_i], float(ts[start_i]))
            if hi > lo:
                self.state = integrate_batch(
                    self.cfg, self.state, depths[lo:hi],
                    None if colors is None else colors[lo:hi],
                    T_odom_cams[lo:hi], jnp.asarray(ts[lo:hi]))
                self._touched_submaps.add(max(self.n_submaps - 1, 0))
                if T_host is not None:
                    for i in range(lo, hi):
                        self._mirror_frame(T_host[i], float(ts[i]))
        # persist the interval clock even when the last rollover(s) were
        # saturation-DROPPED (step() does `self.last_start = t` on that
        # path): leaving it at the last REAL start would re-fire
        # _rollover_sat every window instead of once per interval —
        # warning flood + over-counted dropped_submaps
        self.last_start = last
        return len(starts)


def optimize_local(cfg: MapperConfig, state: MapperState,
                   solver_cfg: Optional[pg.SolverConfig] = None) -> MapperState:
    """Run the local pose graph over submap poses (voxgraph's per-submap
    PGO; constraints = odometry chain + any added loop closures, plus
    absolute height priors when cfg.height_prior_stddev > 0).

    ``solver_cfg`` defaults to cfg.local_solver (robust-kernel settings
    live there), falling back to pg.SolverConfig()."""
    if solver_cfg is None:
        solver_cfg = cfg.local_solver or pg.SolverConfig()
    res = pg.optimize(state.collection.T_odom_submap, state.constraints,
                      solver_cfg,
                      heights=(state.heights
                               if cfg.height_prior_stddev > 0 else None))
    col = dataclasses.replace(state.collection, T_odom_submap=res.poses)
    return dataclasses.replace(state, collection=col)


def add_loop_closure(state: MapperState, i: int, j: int, T_i_j: Array,
                     sqrt_info: Optional[Array] = None) -> MapperState:
    """Add an intra-robot loop-closure constraint between submaps i and j
    (reference: loopClosureCallback → voxgraph loop topic)."""
    return dataclasses.replace(
        state, constraints=state.constraints.add(i, j, T_i_j, sqrt_info)
    )


def merged_layer(cfg: MapperConfig, col: SubmapCollection,
                 growth_cap: int = 4) -> vx.TsdfLayer:
    """Rebuild the merged odom-frame TSDF from all submaps (client
    MapServer updatePastTsdf, map_server.cpp:59-73).

    The merge target's block pool auto-grows to the next power-of-two
    above the summed live-block count (an upper bound of the union),
    capped at ``growth_cap``× the configured pool — stock configs must
    not silently truncate the merged map on normal missions (VERDICT r3
    Weak #6; the reference's layers grow dynamically)."""
    import numpy as np

    spec = cfg.spec
    n = int(col.num_submaps)
    if growth_cap > 0 and n:
        total = int(np.asarray(col.layers.num_blocks)[:n].sum())
        if total > spec.max_blocks:
            need = min(1 << (total - 1).bit_length(),
                       growth_cap * spec.max_blocks, spec.grid_dim ** 3)
            if need > spec.max_blocks:
                spec = dataclasses.replace(spec, max_blocks=need)
    merged = vx.create_tsdf_layer(spec)
    for k in range(n):
        merged = merge_ops.merge_layer_into_sized(
            spec, merged, _get_layer(col.layers, jnp.asarray(k)),
            col.T_odom_submap[k],
            src_spec=cfg.spec if spec != cfg.spec else None,
        )
    return merged


@jax.jit
def _composed_histories(T_odom_submap: Array, hist_poses: Array) -> Array:
    """(S,7)×(S,H,7) → (S,H,7) odom-frame poses, one fixed-shape program."""
    return jax.vmap(lambda T, ps: jax.vmap(lambda p: geo.compose(T, p))(ps))(
        T_odom_submap, hist_poses)


def trajectory(col: SubmapCollection) -> Tuple[Array, Array]:
    """Full odom-frame trajectory (stamps (N,), poses (N,7)) from per-submap
    histories re-posed by the (possibly optimized) submap poses — the
    reference's getPoseHistory (submap_collection.h:95-144)."""
    import numpy as np

    all_poses = np.asarray(
        _composed_histories(col.T_odom_submap, col.hist_poses))
    all_stamps = np.asarray(col.hist_stamps)
    counts = np.asarray(col.hist_count)
    n = int(col.num_submaps)
    stamps, poses = [], []
    for k in range(n):
        h = int(counts[k])
        if h == 0:
            continue
        stamps.append(all_stamps[k, :h])
        poses.append(all_poses[k, :h])
    if not stamps:
        return jnp.zeros((0,)), jnp.zeros((0, 7))
    return (jnp.asarray(np.concatenate(stamps)),
            jnp.asarray(np.concatenate(poses)))
