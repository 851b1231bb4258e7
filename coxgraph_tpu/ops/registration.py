"""Dense submap-to-submap registration — replaces voxgraph's
RegistrationConstraint ("explicit_to_implicit" TSDF alignment,
server.yaml:28-31, sampling_ratio 0.3) and the ICP-style relative-pose
estimation used for map fusion.

Residual per sampled surface point p of submap A:
    r(p) = sdf_B( T_B⁻¹ · T_O_A · p ) − sdf_A(p)
i.e. A's explicit surface evaluated in B's implicit field. Points are the
reference's cached "registration point" samples (voxgraph VoxgraphSubmap
ISDF sample cache, SURVEY.md §2.9): surface-band voxels with high weight,
extracted once per submap into a fixed-capacity buffer.

Everything is batched: residuals + 12-dim pose Jacobians come from vmap'd
forward-mode autodiff straight through the trilinear gather (piecewise
linear ⇒ exact), and the GN normal equations reduce as batched elementwise products and sums.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core import geometry as geo
from ..core import voxel as vx

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    max_points: int = 2048        # surface samples per submap
    min_weight: float = 0.1       # observation gate (mesh_min_weight-like)
    band: float = 0.5             # |sdf| < band·truncation counts as surface
    huber_delta: float = 0.1      # m, robust loss on sdf residuals
    iterations: int = 12          # GN iterations for pairwise alignment
    damping: float = 1e-3
    # LM iterations per DEVICE PROGRAM in the batched phase-2 solve
    # (global_opt._phase2_chunk). 0 ⇒ all iterations in one fused
    # program (lowest solve wall — bench/offline solves). On a shared
    # device, every other thread's readback queues behind the in-flight
    # program (CLAUDE.md shared-device rule), so streaming servers set
    # this to 1-2: the carry stays on device (no extra readbacks, one
    # extra dispatch each) while the longest program drops from the
    # whole solve to one-two iterations.
    phase2_dispatch_iters: int = 0
    # Block budget per submap in the STACKED field view of the batched
    # phase-2 solve (global_opt._phase2_chunk): live pool rows [0, R) of
    # every submap are stacked into one (S·R, v³) field so all pairs
    # sample in ONE dispatch. Blocks beyond R (late allocations in very
    # large submaps) fall out of the registration sampling only — the
    # reference subsamples registration points anyway (sampling_ratio
    # 0.3, server.yaml:30). Bounds the transient stack memory.
    max_reg_blocks: int = 1024


@partial(jax.jit, static_argnums=(0, 2))
def extract_surface_points(spec: vx.VoxelGridSpec, layer: vx.TsdfLayer,
                           cfg: RegistrationConfig) -> Tuple[Array, Array]:
    """→ (points (P,3) in the layer frame, mask (P,)). Fixed capacity;
    selects the highest-weight surface-band voxels (the reference
    subsamples with sampling_ratio — here: top-weight P samples)."""
    live = (jnp.arange(layer.max_blocks) < layer.num_blocks)[:, None]
    surf = (
        live & (layer.weight > cfg.min_weight)
        & (jnp.abs(layer.sdf) < cfg.band * spec.truncation)
    )
    score = jnp.where(surf, layer.weight, -1.0).reshape(-1)
    # deterministic sub-ULP-scale tie jitter: saturated weights (the
    # integrator caps observation weight) would otherwise make top_k
    # degenerate to lowest-pool-slot order, collapsing every sample into
    # the earliest-allocated corner of the submap — spatially biased
    # registration (voxgraph random-subsamples for the same reason,
    # sampling_ratio 0.3, server.yaml:30)
    h = jnp.arange(score.shape[0], dtype=jnp.uint32) * jnp.uint32(2654435761)
    jitter = (h >> 8).astype(jnp.float32) * (1.0 / (1 << 24))
    score = jnp.where(score > 0, score * (1.0 + 1e-3 * jitter), score)
    _, idx = jax.lax.top_k(score, cfg.max_points)
    mask = score[idx] > 0.0
    centers = vx.voxel_centers_of_block(spec, layer.block_coords)
    pts = centers.reshape(-1, 3)[idx]
    # shift each point to the surface along the SDF gradient direction?
    # The explicit-to-implicit residual handles the offset via −sdf_A(p);
    # keep voxel centers (as voxgraph does with its ISDF samples).
    return pts, mask


@partial(jax.jit, static_argnums=(0, 2))
def surface_point_cache(spec: vx.VoxelGridSpec, layer: vx.TsdfLayer,
                        cfg: RegistrationConfig):
    """→ (pts (P,3), sdf (P,), mask (P,)): the per-submap registration
    point cache (voxgraph VoxgraphSubmap's cached ISDF samples, SURVEY.md
    §2.9) — extracted once per submap version, reused by every
    registration pair and GN iteration."""
    pts, mask = extract_surface_points(spec, layer, cfg)
    s, _, ok = vx.sample_tsdf_trilinear(spec, layer, pts)
    return pts, jnp.where(ok, s, 0.0), mask & ok


def _point_residual(spec, layerB, p_B, sdf_A):
    """sdf_B(p in B frame) − sdf_A; invalid samples → 0 residual."""
    s, w, ok = vx.sample_tsdf_trilinear(spec, layerB, p_B)
    return jnp.where(ok, s - sdf_A, 0.0), ok


@partial(jax.jit, static_argnums=(0,))
def registration_residuals(spec: vx.VoxelGridSpec, layerB: vx.TsdfLayer,
                           pts_A: Array, sdf_A: Array, mask_A: Array,
                           T_O_A: Array, T_O_B: Array):
    """Residuals (P,) + validity for all sampled points at current poses."""
    p_B = geo.transform_points(
        geo.inverse(T_O_B), geo.transform_points(T_O_A, pts_A))
    r, ok = _point_residual(spec, layerB, p_B, sdf_A)
    ok = ok & mask_A
    return jnp.where(ok, r, 0.0), ok


@partial(jax.jit, static_argnums=(0,))
def registration_normal_eq(spec: vx.VoxelGridSpec, layerB: vx.TsdfLayer,
                           pts_A: Array, sdf_A: Array, mask_A: Array,
                           T_O_A: Array, T_O_B: Array,
                           huber_delta: float = 0.1):
    """GN contribution of one registration pair (one compiled program,
    reused across every pair and GN iteration — eager dispatch would
    compile and sync op by op).

    Returns (H (12,12), b (12,), cost, n_valid) where the 12 dims are the
    right-multiplicative tangents (δ_A, δ_B)."""

    def res_fn(dA, dB, p, sA):
        TA = geo.compose(T_O_A, geo.se3_exp(dA))
        TB = geo.compose(T_O_B, geo.se3_exp(dB))
        p_B = geo.transform_points(geo.inverse(TB),
                                   geo.transform_points(TA, p))
        r, ok = _point_residual(spec, layerB, p_B, sA)
        return r, ok

    zero = jnp.zeros((6,))

    def one(p, sA, m):
        r, ok = res_fn(zero, zero, p, sA)
        JA, JB = jax.jacfwd(lambda a, b: res_fn(a, b, p, sA)[0],
                            argnums=(0, 1))(zero, zero)
        ok = ok & m
        # Huber weighting
        w = jnp.minimum(1.0, huber_delta / jnp.maximum(jnp.abs(r), 1e-9))
        w = jnp.where(ok, w, 0.0)
        J = jnp.concatenate([JA, JB])           # (12,)
        return w * r * r, w * jnp.outer(J, J), w * r * J, ok

    cost, H, b, ok = jax.vmap(one)(pts_A, sdf_A, mask_A)
    return (H.sum(0), b.sum(0), 0.5 * cost.sum(),
            ok.sum().astype(jnp.int32))


class RegisterResult(NamedTuple):
    T_A_B: Array          # aligned relative pose
    cost: Array
    initial_cost: Array
    n_inliers: Array


@partial(jax.jit, static_argnums=(0, 4))
def register_pair(spec: vx.VoxelGridSpec, layerA: vx.TsdfLayer,
                  layerB: vx.TsdfLayer, T_A_B_init: Array,
                  cfg: RegistrationConfig = RegistrationConfig(),
                  ) -> RegisterResult:
    """ICP-style alignment of submap B to submap A: refine T_A_B so that
    A's surface points fall on B's zero level set. This provides the
    map-fusion relative transform (reference: the MapFusion measurement
    refined by registration constraints, coxgraph_server.cpp:449-467)."""
    pts_A, mA = extract_surface_points(spec, layerA, cfg)
    sA, _, okA = vx.sample_tsdf_trilinear(spec, layerA, pts_A)
    sdf_A = jnp.where(okA, sA, 0.0)
    mask_A = mA & okA

    def gn_step(carry, _):
        T, _ = carry
        # A frame = "odom": T_O_A = I, T_O_B = T (so T_B⁻¹·p = T⁻¹·p)
        H, b, cost, n = registration_normal_eq(
            spec, layerB, pts_A, sdf_A, mask_A, geo.identity(), T,
            cfg.huber_delta)
        # only δ_B varies (the relative pose); take the B block
        Hbb = H[6:, 6:] + cfg.damping * jnp.eye(6)
        bb = b[6:]
        delta = jax.scipy.linalg.solve(Hbb, -bb, assume_a="pos")
        # guard: reject non-finite or huge steps (degenerate sampling)
        bad = ~jnp.all(jnp.isfinite(delta)) | (jnp.linalg.norm(delta) > 1.0)
        delta = jnp.where(bad, 0.0, delta)
        return (geo.compose(T, geo.se3_exp(delta)), cost), None

    (T, _), _ = jax.lax.scan(
        gn_step, (T_A_B_init, jnp.asarray(0.0)), None, length=cfg.iterations)

    _, _, cost0, _ = registration_normal_eq(
        spec, layerB, pts_A, sdf_A, mask_A, geo.identity(), T_A_B_init,
        cfg.huber_delta)
    _, _, cost1, n1 = registration_normal_eq(
        spec, layerB, pts_A, sdf_A, mask_A, geo.identity(), T,
        cfg.huber_delta)
    return RegisterResult(T_A_B=T, cost=cost1, initial_cost=cost0,
                          n_inliers=n1)
