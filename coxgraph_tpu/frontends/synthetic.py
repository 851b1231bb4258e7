"""Synthetic RGB-D scene rendering — replaces Gazebo/CARLA for tests/bench.

The reference validates end-to-end via Gazebo MAV worlds and CARLA RGB-D
scripts (SURVEY.md §2.6; coxgraph_sim/launch/experiments/*,
scripts/carla_rgbd_ego.py). This build replaces them with an analytic
SDF scene rendered by sphere tracing — fully jittable, exact ground truth
for both depth and the expected TSDF, and fast enough to generate clips
on-device.

Scene = room box (inverted AABB) ∪ spheres ∪ boxes. ``scene_sdf`` doubles
as ground truth for kernel golden tests.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..core import geometry as geo

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class PinholeIntrinsics:
    """Static camera model: z forward, x right, y down."""

    width: int = 640
    height: int = 480
    fx: float = 525.0
    fy: float = 525.0
    cx: float = 319.5
    cy: float = 239.5

    def scaled(self, s: float) -> "PinholeIntrinsics":
        return PinholeIntrinsics(
            width=int(self.width * s), height=int(self.height * s),
            fx=self.fx * s, fy=self.fy * s,
            cx=(self.cx + 0.5) * s - 0.5, cy=(self.cy + 0.5) * s - 0.5,
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Scene:
    """Analytic scene: spheres (N,4)=[cx,cy,cz,r], boxes (M,6)=[min,max],
    room half-extent (3,) — walls of an axis-aligned room centered at
    room_center."""

    spheres: Array
    boxes: Array
    room_center: Array
    room_half: Array


def default_scene() -> Scene:
    """A 10×8×3 m room with a few obstacles (2-robot experiment scale,
    cf. coxgraph_sim 2d3dhouse world)."""
    return Scene(
        spheres=jnp.array(
            [
                [1.5, 1.0, 0.8, 0.8],
                [-2.0, -1.5, 0.6, 0.6],
                [0.5, -2.0, 1.8, 0.4],
            ]
        ),
        boxes=jnp.array(
            [
                [-0.6, 2.0, 0.0, 0.6, 3.2, 1.2],
                [2.8, -2.8, 0.0, 3.6, -1.6, 2.0],
            ]
        ),
        room_center=jnp.array([0.0, 0.0, 1.5]),
        room_half=jnp.array([5.0, 4.0, 1.5]),
    )


def scene_sdf(scene: Scene, p: Array) -> Array:
    """Signed distance of the scene at points (...,3). Negative inside
    solids; the room interior is free space bounded by walls."""
    # room: distance to inside of box = half - |p - c| (negative outside)
    d_wall = jnp.min(
        scene.room_half - jnp.abs(p - scene.room_center), axis=-1
    )  # >0 inside room, 0 at wall → sdf to wall surface
    sdf = d_wall

    def sphere_sdf(s):
        return jnp.linalg.norm(p - s[:3], axis=-1) - s[3]

    sph = jax.vmap(sphere_sdf)(scene.spheres)  # (N, ...)
    sdf = jnp.minimum(sdf, jnp.min(sph, axis=0))

    def box_sdf(b):
        c = 0.5 * (b[:3] + b[3:])
        h = 0.5 * (b[3:] - b[:3])
        q = jnp.abs(p - c) - h
        outside = jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1)
        inside = jnp.minimum(jnp.max(q, axis=-1), 0.0)
        return outside + inside

    box = jax.vmap(box_sdf)(scene.boxes)
    return jnp.minimum(sdf, jnp.min(box, axis=0))


def _ray_dirs(intr: PinholeIntrinsics) -> Array:
    """Unit ray directions in camera frame, (H, W, 3)."""
    u = jnp.arange(intr.width, dtype=jnp.float32)
    v = jnp.arange(intr.height, dtype=jnp.float32)
    uu, vv = jnp.meshgrid(u, v)  # (H, W)
    d = jnp.stack(
        [(uu - intr.cx) / intr.fx, (vv - intr.cy) / intr.fy, jnp.ones_like(uu)],
        axis=-1,
    )
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


@partial(jax.jit, static_argnums=(1, 3, 4))
def render_depth(scene: Scene, intr: PinholeIntrinsics, T_world_cam: Array,
                 max_range: float = 10.0, n_steps: int = 96):
    """Sphere-trace a depth + color frame.

    Returns (depth (H,W) — z-depth along optical axis, 0 where no hit;
    color (H,W,3) in [0,1]). max_range matches the reference's
    max_ray_length_m=10 (coxgraph_client.yaml:60).
    """
    dirs_cam = _ray_dirs(intr)
    R = geo.quat_to_matrix(geo.rotation(T_world_cam))
    origin = geo.translation(T_world_cam)
    dirs = jnp.einsum("ij,hwj->hwi", R, dirs_cam,
                      precision=jax.lax.Precision.HIGHEST)

    def step(carry, _):
        t, hit = carry
        p = origin + t[..., None] * dirs
        d = scene_sdf(scene, p)
        hit = hit | (d < 1e-3)
        t = jnp.where(hit, t, jnp.minimum(t + jnp.maximum(d, 1e-3), max_range))
        return (t, hit), None

    t0 = jnp.zeros(dirs.shape[:2], dtype=jnp.float32)
    hit0 = jnp.zeros(dirs.shape[:2], dtype=jnp.bool_)
    (t, hit), _ = jax.lax.scan(step, (t0, hit0), None, length=n_steps)

    # z-depth (projective) = range * cos(angle to optical axis)
    depth = jnp.where(hit, t * dirs_cam[..., 2], 0.0)

    # simple normal-based shading for color
    p = origin + t[..., None] * dirs
    eps = 1e-3
    n = jnp.stack(
        [
            scene_sdf(scene, p + jnp.array([eps, 0, 0]))
            - scene_sdf(scene, p - jnp.array([eps, 0, 0])),
            scene_sdf(scene, p + jnp.array([0, eps, 0]))
            - scene_sdf(scene, p - jnp.array([0, eps, 0])),
            scene_sdf(scene, p + jnp.array([0, 0, eps]))
            - scene_sdf(scene, p - jnp.array([0, 0, eps])),
        ],
        axis=-1,
    )
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-6)
    shade = 0.5 + 0.5 * jnp.abs(n)
    # viewpoint-invariant procedural texture (function of the 3D point) so
    # feature descriptors match across views — sensor-image stand-in
    def checker(q, s):
        c = jnp.floor(q / s)
        return jnp.mod(c[..., 0] + c[..., 1] + c[..., 2], 2.0)

    tex = (
        0.45
        + 0.22 * checker(p, 0.31)
        + 0.16 * checker(p + 0.123, 0.53)
        + 0.12 * jnp.sin(9.1 * p[..., 0]) * jnp.sin(7.3 * p[..., 1])
    )
    color = jnp.where(hit[..., None], shade * tex[..., None], 0.0)
    return depth, color


def orbit_trajectory(n_frames: int, center: Array, radius: float = 3.0,
                     height: float = 0.0, sweep: float = 2.0 * jnp.pi,
                     start_angle: float = 0.0) -> Array:
    """Camera poses (n,7) orbiting `center`, optical axis aimed at it.

    Replaces the Gazebo MAV trajectories for tests; per-frame poses are the
    ground-truth trajectory for ATE evaluation (TUM export)."""
    a = start_angle + jnp.linspace(0.0, sweep, n_frames, endpoint=False)

    def pose(ang):
        eye = center + jnp.array(
            [radius * jnp.cos(ang), radius * jnp.sin(ang), 0.0]
        ).at[2].add(height)
        fwd = center - eye
        fwd = fwd / jnp.linalg.norm(fwd)
        up_w = jnp.array([0.0, 0.0, -1.0])  # y-down camera
        right = jnp.cross(fwd, up_w)
        right = right / jnp.maximum(jnp.linalg.norm(right), 1e-6)
        down = jnp.cross(fwd, right)
        R = jnp.stack([right, down, fwd], axis=-1)  # columns = cam axes in world
        return geo.make(geo.matrix_to_quat(R), eye)

    return jax.vmap(pose)(a)


def noisy_odometry(key: Array, poses: Array, rot_std: float = 0.002,
                   trans_std: float = 0.005) -> Array:
    """Integrate ground-truth relative motions with per-step noise → drifting
    odometry (stand-in for the reference's external VIO frontend, L0)."""
    n = poses.shape[0]
    rels = geo.relative(poses[:-1], poses[1:])
    keys = jax.random.split(key, n - 1)
    noise = jax.vmap(
        lambda k: jnp.concatenate(
            [
                jax.random.normal(k, (3,)) * rot_std,
                jax.random.normal(jax.random.fold_in(k, 1), (3,)) * trans_std,
            ]
        )
    )(keys)
    noisy_rels = jax.vmap(lambda T, xi: geo.compose(T, geo.se3_exp(xi)))(rels, noise)

    def step(T, rel):
        Tn = geo.compose(T, rel)
        return Tn, Tn

    _, out = jax.lax.scan(step, poses[0], noisy_rels)
    return jnp.concatenate([poses[:1], out], axis=0)
