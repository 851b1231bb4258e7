"""Feature detection, binary descriptors, matching, and geometric
verification — the loop-closure frontend capability the reference delegates
to external ORB/BRISK + BoW + RANSAC systems (corbslam /
pose_graph_backend: launch/utils/pose_graph_backend.launch:13-60
``bow_voc``, ``loop_candidate_min_score``, SAC parameters; SURVEY.md §2.9).

Accelerator design — everything dense, fixed-capacity, batched:
  * Harris corners (Sobel + structure tensor, elementwise), 3×3 max-pool NMS,
    top-K selection;
  * upright BRIEF-256 binary descriptors packed into 8 uint32 words;
  * brute-force Hamming matching (XOR + vectorized popcount) with mutual
    nearest + ratio test — on the device, brute force over whole keyframe
    databases replaces the BoW inverted index;
  * batched 3D-3D RANSAC: hundreds of Kabsch hypotheses solved in parallel
    by vmap'd SVD, inliers counted densely, final refit on the inlier set.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import geometry as geo
from ..frontends.synthetic import PinholeIntrinsics

Array = jax.Array
_HI = jax.lax.Precision.HIGHEST  # full f32, never TF32

_N_BITS = 256
_N_WORDS = _N_BITS // 32
# deterministic BRIEF sampling pattern (pairs within a 31px patch)
_rng = np.random.RandomState(7)
_PATTERN_A = jnp.asarray(_rng.randint(-15, 16, size=(_N_BITS, 2)), jnp.int32)
_PATTERN_B = jnp.asarray(_rng.randint(-15, 16, size=(_N_BITS, 2)), jnp.int32)


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    max_keypoints: int = 512
    harris_k: float = 0.04
    nms_radius: int = 3
    min_response: float = 0.01   # fraction of the frame's peak response
    border: int = 16
    match_max_hamming: int = 64
    match_ratio: float = 0.9
    ransac_iters: int = 256
    ransac_inlier_dist: float = 0.1   # m
    # final refit gate as a fraction of ransac_inlier_dist: after the
    # consensus refit, one more Kabsch over the TIGHT inliers — the
    # loose 0.1 m gate admits noisy-depth correspondences whose average
    # biases the closure ~cm-scale (real-sensor clip); 0 disables
    ransac_refine_frac: float = 0.5
    # reject keypoints whose 3×3 depth neighbourhood is invalid or
    # spreads more than this fraction of the depth (silhouette/depth-edge
    # keypoints lift to wrong 3-D points under sensor noise); 0 disables
    depth_edge_rel: float = 0.04
    min_inliers: int = 12


class Keypoints(NamedTuple):
    uv: Array        # (K,2) float pixel coords (x,y)
    response: Array  # (K,)
    valid: Array     # (K,) bool
    desc: Array      # (K, 8) uint32 packed BRIEF
    p_cam: Array     # (K,3) backprojected camera-frame points
    has_depth: Array  # (K,) bool


def _gray(color: Array) -> Array:
    return color.mean(axis=-1) if color.ndim == 3 else color


def _box_blur(x: Array, r: int = 1) -> Array:
    k = 2 * r + 1
    w = jnp.ones((k, k), x.dtype) / (k * k)
    return jax.lax.conv_general_dilated(
        x[None, None], w[None, None], (1, 1), "SAME", precision=_HI)[0, 0]


def _sobel(x: Array) -> Tuple[Array, Array]:
    kx = jnp.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], x.dtype) / 8.0
    ky = kx.T
    gx = jax.lax.conv_general_dilated(x[None, None], kx[None, None], (1, 1),
                                      "SAME", precision=_HI)[0, 0]
    gy = jax.lax.conv_general_dilated(x[None, None], ky[None, None], (1, 1),
                                      "SAME", precision=_HI)[0, 0]
    return gx, gy


def harris_response(gray: Array, k: float = 0.04) -> Array:
    gx, gy = _sobel(gray)
    xx = _box_blur(gx * gx, 2)
    yy = _box_blur(gy * gy, 2)
    xy = _box_blur(gx * gy, 2)
    det = xx * yy - xy * xy
    tr = xx + yy
    return det - k * tr * tr


def _nms(resp: Array, radius: int) -> Array:
    k = 2 * radius + 1
    mx = jax.lax.reduce_window(resp, -jnp.inf, jax.lax.max, (k, k), (1, 1),
                               "SAME")
    return resp >= mx


@partial(jax.jit, static_argnums=(0, 3))
def detect_and_describe(intr: PinholeIntrinsics, color: Array, depth: Array,
                        cfg: FeatureConfig = FeatureConfig()) -> Keypoints:
    """Harris + BRIEF + backprojection in one pass over an RGB-D frame."""
    gray = _gray(color)
    resp = harris_response(gray, cfg.harris_k)
    H, W = resp.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    interior = ((xx >= cfg.border) & (xx < W - cfg.border)
                & (yy >= cfg.border) & (yy < H - cfg.border))
    thresh = cfg.min_response * jnp.maximum(resp.max(), 1e-12)
    good = _nms(resp, cfg.nms_radius) & (resp > thresh) & interior
    score = jnp.where(good, resp, -1.0).reshape(-1)
    top, idx = jax.lax.top_k(score, cfg.max_keypoints)
    u = (idx % W).astype(jnp.int32)
    v = (idx // W).astype(jnp.int32)
    valid = top > 0

    # BRIEF on the blurred image
    smooth = _box_blur(gray, 2)

    def sample(pu, pv, off):
        su = jnp.clip(pu[:, None] + off[None, :, 0], 0, W - 1)
        sv = jnp.clip(pv[:, None] + off[None, :, 1], 0, H - 1)
        return smooth[sv, su]                      # (K, 256)

    ia = sample(u, v, _PATTERN_A)
    ib = sample(u, v, _PATTERN_B)
    bits = (ia < ib).astype(jnp.uint32).reshape(-1, _N_WORDS, 32)
    desc = jnp.sum(bits << jnp.arange(32, dtype=jnp.uint32)[None, None, :],
                   axis=-1).astype(jnp.uint32)

    d = depth[v, u]
    has_depth = (d > 0.05) & (d < 50.0) & valid
    if cfg.depth_edge_rel > 0:
        # Reject keypoints on DEPTH EDGES: Harris corners concentrate on
        # object silhouettes (texture contrast), where a 1-px keypoint
        # shift under sensor noise/JPEG flips the lifted 3-D point
        # between fore- and background — meters of correspondence error
        # that RANSAC's loose gate can't always reject (measured ~5-7 cm
        # systematic closure bias on the real-noise clip,
        # tests/fixtures/tum_real). Standard RGB-D practice: require the
        # 3×3 depth neighbourhood valid and its spread ≲ rel·d.
        dmin = depth
        dmax = depth
        dok = depth > 0
        # edge-replicated pad instead of jnp.roll: roll WRAPS at image
        # borders, so an edge-row/column keypoint would compare its 3×3
        # depth spread against pixels from the opposite image side
        # (spurious accept/reject when cfg.border < 1 — ADVICE r4)
        dpad = jnp.pad(depth, 1, mode="edge")
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                s = dpad[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                dok = dok & (s > 0)
                dmin = jnp.minimum(dmin, s)
                dmax = jnp.maximum(dmax, s)
        spread_ok = (dmax - dmin)[v, u] < cfg.depth_edge_rel * jnp.maximum(
            d, 0.05)
        has_depth = has_depth & dok[v, u] & spread_ok
    x = (u.astype(jnp.float32) - intr.cx) / intr.fx * d
    y = (v.astype(jnp.float32) - intr.cy) / intr.fy * d
    p_cam = jnp.stack([x, y, d], axis=-1)

    return Keypoints(
        uv=jnp.stack([u, v], -1).astype(jnp.float32),
        response=top, valid=valid, desc=desc, p_cam=p_cam,
        has_depth=has_depth)


def _popcount32(x: Array) -> Array:
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return (x * jnp.uint32(0x01010101)) >> 24


def _unpack_pm1(d: Array) -> Array:
    """(..., 8) packed uint32 → (..., 256) bf16 of ±1 per bit."""
    bits = (d[..., :, None] >> jnp.arange(32, dtype=jnp.uint32)) & 1
    pm1 = 2.0 * bits.astype(jnp.bfloat16) - 1.0
    return pm1.reshape(*d.shape[:-1], _N_WORDS * 32)


def hamming_matrix(da: Array, db: Array) -> Array:
    """(Ka,8)×(Kb,8) uint32 → (Ka,Kb) int32 Hamming distances.

    Matmul form: with descriptors unpacked to ±1 bit vectors,
    ``dot(a, b) = nbits − 2·hamming``, so the whole distance matrix is
    one 256-deep bf16 matmul on the tensor cores instead of Ka·Kb·8
    xor+popcount chains. Exact: ±1 is exact in bf16, the product
    accumulates in f32, and |dot| ≤ 256 is integer-exact there."""
    nbits = _N_WORDS * 32
    a = _unpack_pm1(da)
    b = _unpack_pm1(db)
    dot = jax.lax.dot_general(a, b, (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.float32)
    return ((nbits - dot) * 0.5).astype(jnp.int32)


@partial(jax.jit, static_argnums=2)
def match_descriptors(a: Keypoints, b: Keypoints,
                      cfg: FeatureConfig = FeatureConfig()):
    """Mutual-nearest Hamming matching with ratio test.

    → (idx_b (Ka,) int32 match in b or -1, dist (Ka,))."""
    D = hamming_matrix(a.desc, b.desc)
    BIG = jnp.int32(10_000)
    D = jnp.where(a.valid[:, None] & b.valid[None, :], D, BIG)
    best_b = jnp.argmin(D, axis=1)
    d1 = jnp.min(D, axis=1)
    # second-best for ratio test
    D2 = D.at[jnp.arange(D.shape[0]), best_b].set(BIG)
    d2 = jnp.min(D2, axis=1)
    best_a_of_b = jnp.argmin(D, axis=0)
    mutual = best_a_of_b[best_b] == jnp.arange(D.shape[0])
    ok = (
        mutual & (d1 <= cfg.match_max_hamming)
        & (d1.astype(jnp.float32) <= cfg.match_ratio * d2.astype(jnp.float32))
    )
    return jnp.where(ok, best_b, -1), d1


def _kabsch(pa: Array, pb: Array, w: Array) -> Array:
    """Weighted rigid fit T with pb ≈ R·pa + t → (7,) [q,t].
    pa/pb (N,3), w (N,) ≥ 0."""
    ws = jnp.maximum(w.sum(), 1e-6)
    ca = (w[:, None] * pa).sum(0) / ws
    cb = (w[:, None] * pb).sum(0) / ws
    A = jnp.matmul((w[:, None] * (pb - cb)).T, pa - ca, precision=_HI)
    U, _, Vt = jnp.linalg.svd(A)
    d = jnp.sign(jnp.linalg.det(jnp.matmul(U, Vt, precision=_HI)))
    S = jnp.diag(jnp.array([1.0, 1.0, 1.0]) .at[2].set(d))
    R = jnp.matmul(jnp.matmul(U, S, precision=_HI), Vt, precision=_HI)
    t = cb - jnp.matmul(R, ca, precision=_HI)
    return geo.make(geo.matrix_to_quat(R), t)


class RansacResult(NamedTuple):
    T_b_a: Array       # transform mapping a-frame points into b's frame
    n_inliers: Array
    inlier_mask: Array


@partial(jax.jit, static_argnums=(3,))
def ransac_rigid(pa: Array, pb: Array, valid: Array,
                 cfg: FeatureConfig = FeatureConfig(),
                 key: Array = None) -> RansacResult:
    """Batched 3-point RANSAC over 3D-3D correspondences (pa→pb)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    M = pa.shape[0]
    n_valid = jnp.maximum(valid.sum(), 1)
    # sample valid indices with probability ∝ validity
    probs = valid.astype(jnp.float32) / n_valid
    idx = jax.random.choice(key, M, shape=(cfg.ransac_iters, 3), p=probs)

    def hypo(ix):
        T = _kabsch(pa[ix], pb[ix], jnp.ones(3))
        err = jnp.linalg.norm(geo.transform_points(T, pa) - pb, axis=-1)
        inl = valid & (err < cfg.ransac_inlier_dist)
        return inl.sum(), T

    scores, Ts = jax.vmap(hypo)(idx)
    best = jnp.argmax(scores)
    T0 = Ts[best]
    err = jnp.linalg.norm(geo.transform_points(T0, pa) - pb, axis=-1)
    inl = valid & (err < cfg.ransac_inlier_dist)
    # refit on inliers (two rounds)
    T1 = _kabsch(pa, pb, inl.astype(jnp.float32))
    err1 = jnp.linalg.norm(geo.transform_points(T1, pa) - pb, axis=-1)
    inl1 = valid & (err1 < cfg.ransac_inlier_dist)
    T2 = _kabsch(pa, pb, inl1.astype(jnp.float32))
    if cfg.ransac_refine_frac > 0:
        # tight final refit: the loose consensus gate keeps noisy-depth
        # matches whose mean error biases T2 (~cm on real-noise frames);
        # refit over the tight subset when it still supports a pose
        err2 = jnp.linalg.norm(geo.transform_points(T2, pa) - pb, axis=-1)
        tight = valid & (err2 < cfg.ransac_refine_frac
                         * cfg.ransac_inlier_dist)
        T3 = _kabsch(pa, pb, tight.astype(jnp.float32))
        # absolute minimum support: `>= min(4, inl1.sum())` was trivially
        # true at inl1 < 4 (a refit over an empty/degenerate tight set
        # could replace T2 — ADVICE r4)
        use = tight.sum() >= 4
        T2 = jnp.where(use, T3, T2)
    return RansacResult(T_b_a=T2, n_inliers=inl1.sum(), inlier_mask=inl1)


@partial(jax.jit, static_argnames=("cfg", "return_spread"))
def estimate_relative_pose(kp_a: Keypoints, kp_b: Keypoints,
                           cfg: FeatureConfig = FeatureConfig(),
                           key: Array = None, return_spread: bool = False):
    """Full pipeline: match + RANSAC → (T_camA_camB, n_inliers).

    T_camA_camB maps camera-B points into camera A (the MapFusion
    transform convention of the reference, MapFusion.msg).

    ``return_spread=True`` additionally returns the inlier point cloud's
    planar SPREAD (√ of the second eigenvalue of its 3-D covariance, in
    metres): spatially concentrated inliers make the Kabsch fit
    rotation-degenerate — a 13-inlier consensus confined to one photo
    patch measured 45 cm of translation error on the real-noise clip
    while well-spread 13-inlier fits were ≤ 3 cm. Loop detectors should
    gate on it (LoopDetectorConfig.min_inlier_spread)."""
    mb, _ = match_descriptors(kp_a, kp_b, cfg)
    M = kp_a.p_cam.shape[0]
    pa = kp_a.p_cam
    pb = kp_b.p_cam[jnp.maximum(mb, 0)]
    valid = (mb >= 0) & kp_a.has_depth & kp_b.has_depth[jnp.maximum(mb, 0)]
    res = ransac_rigid(pa, pb, valid, cfg, key)
    # ransac gives T with pB ≈ T·pA i.e. T_camB_camA; invert
    if not return_spread:
        return geo.inverse(res.T_b_a), res.n_inliers
    w = res.inlier_mask.astype(jnp.float32)
    n = jnp.maximum(w.sum(), 1.0)
    mu = (w[:, None] * pa).sum(0) / n
    d = (pa - mu) * w[:, None]
    cov = jnp.matmul(d.T, d, precision=_HI) / n
    evals = jnp.linalg.eigvalsh(cov)          # ascending
    spread = jnp.sqrt(jnp.maximum(evals[1], 0.0))
    return geo.inverse(res.T_b_a), res.n_inliers, spread
