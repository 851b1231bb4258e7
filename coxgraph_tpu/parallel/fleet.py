"""Multi-robot SPMD over a device mesh — the device-mesh replacement for the
reference's per-robot ROS processes (SURVEY.md §2 parallelism inventory:
robot/data parallelism = N independent client pipelines,
launch/cvg/run_experiment_cvg.launch:5-7; central Ceres solve
backend/pose_graph.h:52-73).

Design:
  * fleet state = every robot's MapperState stacked along a leading
    ``robot`` axis, sharded over a 1-D ``Mesh(('robot',))``;
  * dense integration runs embarrassingly parallel under `shard_map`;
  * the global pose graph solve is a **distributed Gauss-Newton**: each
    device assembles normal equations for its robot's own constraints
    against the replicated global pose vector, H/b are `psum`-reduced over
    the ICI, the replicated inter-robot (loop-closure / map-fusion)
    constraints are added identically on every device after the reduction,
    and the damped Cholesky solve + LM loop run replicated. This replaces
    the reference's client→server submap RPC + central Ceres with pure
    collectives.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..core import geometry as geo
from ..mapper import submap_mapper as sm
from ..ops import tsdf as tsdf_ops
from ..solver import pose_graph as pg

Array = jax.Array


def make_robot_mesh(n_robots: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    n = n_robots or len(devs)
    assert n <= len(devs), f"{n} robots > {len(devs)} devices"
    return Mesh(np.array(devs[:n]), ("robot",))


def create_fleet(cfg: sm.MapperConfig, n_robots: int) -> sm.MapperState:
    one = sm.create_mapper(cfg)
    return jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n_robots,) + x.shape).copy(), one
    )


def shard_fleet(fleet: sm.MapperState, mesh: Mesh) -> sm.MapperState:
    shard = NamedSharding(mesh, P("robot"))
    return jax.tree.map(lambda x: jax.device_put(x, shard), fleet)


def robot_state(fleet: sm.MapperState, r: int) -> sm.MapperState:
    return jax.tree.map(lambda x: x[r], fleet)


def _integrate_one(cfg: sm.MapperConfig, state: sm.MapperState, depth, color,
                   T_odom_cam, t) -> sm.MapperState:
    """Single-robot integrate body (the mapper's stacked-pool impl)."""
    return sm.integrate_impl(cfg, state, depth, color, T_odom_cam, t)


def _start_one(cfg: sm.MapperConfig, state: sm.MapperState, T_odom_cam,
               t, go) -> sm.MapperState:
    """Conditionally roll the submap on one robot (lax.cond body)."""

    def start(s):
        col = s.collection
        k = col.num_submaps
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
        cons = jax.lax.cond(
            k > 0,
            lambda c: c.add(prev, k, T_prev_new,
                            cfg.odom_sqrt_info * jnp.eye(6)),
            lambda c: c,
            s.constraints)
        return dataclasses.replace(s, collection=col, constraints=cons)

    return jax.lax.cond(go, start, lambda s: s, state)


@partial(jax.jit, static_argnums=(0, 1), donate_argnums=2)
def fleet_step(cfg: sm.MapperConfig, mesh: Mesh, fleet: sm.MapperState,
               depths: Array, colors: Array, T_odom_cams: Array,
               ts: Array) -> sm.MapperState:
    """One full fleet step: per-robot submap rollover (time-driven, inside
    jit via lax.cond) + dense integration, SPMD over the mesh.

    depths (R,H,W), colors (R,H,W,3), T_odom_cams (R,7), ts (R,)."""

    def per_robot(state, depth, color, T, t):
        col = state.collection
        n = col.num_submaps
        elapsed = t - col.start_time[jnp.maximum(n - 1, 0)]
        go = (n == 0) | (elapsed >= cfg.submap_interval - 1e-6)
        state = _start_one(cfg, state, T, t, go)
        return _integrate_one(cfg, state, depth, color, T, t)

    def shard_fn(fleet, depths, colors, Ts, ts):
        return jax.vmap(partial(per_robot))(fleet, depths, colors, Ts, ts)

    return shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("robot"),) * 5,
        out_specs=P("robot"),
        check_vma=False,
    )(fleet, depths, colors, T_odom_cams, ts)


def globalize_constraints(c: pg.RelPoseConstraints,
                          max_submaps: int) -> pg.RelPoseConstraints:
    """Re-index per-robot constraint pools (leading (R, M) axes) into the
    global pose vector: (robot r, submap s) → r·S + s."""
    R = c.i.shape[0]
    off = (jnp.arange(R, dtype=jnp.int32) * max_submaps)[:, None]
    return dataclasses.replace(c, i=c.i + off, j=c.j + off)


@partial(jax.jit, static_argnums=(0, 1, 4))
def fleet_optimize(cfg: sm.MapperConfig, mesh: Mesh, fleet: sm.MapperState,
                   inter_robot: pg.RelPoseConstraints,
                   solver_cfg: pg.SolverConfig = pg.SolverConfig(),
                   ) -> Tuple[sm.MapperState, Array]:
    """Distributed LM over ALL robots' submap poses (R·S global poses).

    inter_robot: a replicated constraint pool whose indices are already
    global (use globalize helpers) — the map-fusion constraints of the
    reference server (coxgraph_server.cpp:449-467).
    Returns (fleet with updated T_odom_submap, global poses (R·S,7))."""
    R = fleet.constraints.i.shape[0]
    S = cfg.max_submaps
    N = R * S
    local_global = globalize_constraints(fleet.constraints, S)
    fixed0 = jnp.zeros((N,), jnp.bool_).at[0].set(True)

    # poses touched by any constraint anywhere (computed outside shard_map
    # on the full pools — cheap)
    touched = jnp.zeros((N,), jnp.bool_)
    for c in (local_global, inter_robot):
        ii = c.i.reshape(-1)
        jj = c.j.reshape(-1)
        vv = c.valid.reshape(-1)
        touched = touched.at[jnp.where(vv, ii, N)].set(True, mode="drop")
        touched = touched.at[jnp.where(vv, jj, N)].set(True, mode="drop")
    fixed = fixed0 | ~touched

    def shard_fn(T_odom_submap, local_cons, inter_cons):
        # T_odom_submap: (R/n, S, 7) shard; local_cons leaves (R/n, M, ...)
        local = pg.RelPoseConstraints(
            i=local_cons.i.reshape(-1),
            j=local_cons.j.reshape(-1),
            T_meas=local_cons.T_meas.reshape(-1, 7),
            sqrt_info=local_cons.sqrt_info.reshape(-1, 6, 6),
            valid=local_cons.valid.reshape(-1),
            count=jnp.sum(local_cons.count),
        )

        def normal_eq(poses):
            H, b, _ = pg._build_normal_equations(poses, local, solver_cfg,
                                                 fixed)
            H = jax.lax.psum(H, "robot")
            b = jax.lax.psum(b, "robot")
            Hi, bi, _ = pg._build_normal_equations(poses, inter_cons,
                                                   solver_cfg, fixed)
            # inter-robot part is replicated → identical on every device;
            # added once after the reduction. (The fixed-pose unit diagonal
            # is summed R+1 times — harmless: those rows/cols are zero and
            # any positive diagonal pins delta to 0.)
            return H + Hi, b + bi

        def cost_fn(poses):
            cl = pg._total_cost(poses, local, solver_cfg)
            return jax.lax.psum(cl, "robot") + pg._total_cost(
                poses, inter_cons, solver_cfg)

        poses0 = jax.lax.all_gather(T_odom_submap, "robot", tiled=True)
        poses0 = poses0.reshape(N, 7)

        def lm_step(carry, _):
            poses, lam = carry
            H, b = normal_eq(poses)
            # both _build calls zeroed fixed rows and added unit diag; the
            # diag correction above leaves exactly one unit diagonal
            Hd = H + lam * jnp.diag(jnp.maximum(jnp.diag(H), 1e-8))
            delta = jax.scipy.linalg.solve(Hd, -b, assume_a="pos")
            new_poses = pg._apply_delta(poses, delta, solver_cfg)
            accept = cost_fn(new_poses) < cost_fn(poses)
            poses = jnp.where(accept, new_poses, poses)
            lam = jnp.clip(jnp.where(accept, lam * solver_cfg.damping_down,
                                     lam * solver_cfg.damping_up), 1e-9, 1e6)
            return (poses, lam), None

        (poses, _), _ = jax.lax.scan(
            lm_step, (poses0, jnp.asarray(solver_cfg.damping_init)), None,
            length=solver_cfg.iterations)

        # slice this device's robots back out
        idx = jax.lax.axis_index("robot")
        per = T_odom_submap.shape[0]
        mine = jax.lax.dynamic_slice_in_dim(
            poses.reshape(R, S, 7), idx * per, per, axis=0)
        return mine, poses

    new_T, poses = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("robot"), P("robot"), P()),
        out_specs=(P("robot"), P()),
        check_vma=False,
    )(fleet.collection.T_odom_submap, local_global, inter_robot)

    col = dataclasses.replace(fleet.collection, T_odom_submap=new_T)
    return dataclasses.replace(fleet, collection=col), poses


def ici_bytes_per_optimize(cfg: sm.MapperConfig, n_robots: int,
                           solver_cfg: pg.SolverConfig = pg.SolverConfig(),
                           ) -> dict:
    """Static ICI traffic accounting for one fleet_optimize call (the
    exchange-layer byte counters of SURVEY.md §5.1/§5.8): per LM
    iteration each device reduces H (6N·6N f32) + b (6N) + the scalar
    cost over the robot axis, after one initial all-gather of the pose
    pool (N·7 f32). Counts are the logical reduced payload per device; a
    ring all-reduce moves ≈2·(n-1)/n of that on the wire."""
    N = n_robots * cfg.max_submaps
    d = 6 * N
    per_iter = (d * d + d + 1) * 4
    return {
        "n_iterations": solver_cfg.iterations,
        "all_gather_bytes": N * 7 * 4,
        "per_iteration_bytes": per_iter,
        "per_device_bytes": N * 7 * 4 + solver_cfg.iterations * per_iter,
    }
