"""SE(3)/SO(3) geometry on arrays — replaces minkindr/kindr/tf2/Eigen.

The reference binds all pose math to kindr's ``QuatTransformation``
(reference: coxgraph/include/coxgraph/common.h:40-48) and interpolates pose
histories componentwise (submap_collection.h:115-116,
``kindr::interpolateComponentwise``). Here a transform is a flat
``(..., 7)`` float array ``[qw, qx, qy, qz, tx, ty, tz]`` so every op
vmaps/jits and batches trivially.

Conventions:
  * Quaternions are Hamilton, scalar-first ``(w, x, y, z)``, unit norm.
  * ``T_A_B`` maps points from frame B to frame A: ``p_A = R(q) p_B + t``.
  * The se(3) tangent is ``[wx, wy, wz, vx, vy, vz]`` (rotation first).
  * A 4-DoF pose is ``[x, y, z, yaw]`` — the reference optimizes client map
    frames in 4-DoF (backend/node_collection.h:21-25,
    voxgraph AngleLocalParameterization).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array

_EPS = 1e-8
# f32 contractions ask for full f32: the default may run in TF32 (about
# three decimal digits) on GPU tensor cores
_HI = jax.lax.Precision.HIGHEST


def identity(dtype=jnp.float32) -> Array:
    """The identity transform as a (7,) array."""
    return jnp.array([1.0, 0, 0, 0, 0, 0, 0], dtype=dtype)


def make(q: Array, t: Array) -> Array:
    """Pack quaternion (...,4) and translation (...,3) into (...,7)."""
    return jnp.concatenate([q, t], axis=-1)


def rotation(T: Array) -> Array:
    return T[..., :4]


def translation(T: Array) -> Array:
    return T[..., 4:7]


# ---------------------------------------------------------------------------
# Quaternions
# ---------------------------------------------------------------------------


def quat_normalize(q: Array) -> Array:
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q / jnp.maximum(n, _EPS)


def quat_mul(a: Array, b: Array) -> Array:
    """Hamilton product a ⊗ b, scalar-first, broadcasting over batch dims."""
    aw, ax, ay, az = (a[..., i] for i in range(4))
    bw, bx, by, bz = (b[..., i] for i in range(4))
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conj(q: Array) -> Array:
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_rotate(q: Array, v: Array) -> Array:
    """Rotate vectors v (...,3) by unit quaternions q (...,4).

    Uses the two-cross-product form (cheaper than building R)."""
    qw = q[..., :1]
    qv = q[..., 1:4]
    uv = jnp.cross(qv, v)
    uuv = jnp.cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def quat_to_matrix(q: Array) -> Array:
    """Unit quaternion (...,4) → rotation matrix (...,3,3)."""
    w, x, y, z = (q[..., i] for i in range(4))
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(R: Array) -> Array:
    """Rotation matrix (...,3,3) → unit quaternion (...,4), branch-free.

    Shepperd's method via the 4 candidate constructions, selecting the
    numerically best with where() so it jits and batches."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, _EPS))

    # candidate 0: trace
    s0 = safe_sqrt(1.0 + tr) * 2.0
    q0 = jnp.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                    (m10 - m01) / s0], axis=-1)
    # candidate 1: m00 dominant
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = jnp.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                    (m02 + m20) / s1], axis=-1)
    # candidate 2: m11 dominant
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = jnp.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                    (m12 + m21) / s2], axis=-1)
    # candidate 3: m22 dominant
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = jnp.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                    0.25 * s3], axis=-1)

    cond0 = tr > 0.0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = jnp.where(
        cond0[..., None], q0,
        jnp.where(cond1[..., None], q1, jnp.where(cond2[..., None], q2, q3)),
    )
    # canonicalize sign (w >= 0) and normalize
    q = jnp.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SO(3) exp / log
# ---------------------------------------------------------------------------


def so3_exp(w: Array) -> Array:
    """Axis-angle (...,3) → unit quaternion (...,4). Taylor-safe near 0."""
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    half = 0.5 * theta
    small = theta2 < 1e-8
    # sin(half)/theta with series fallback: 0.5 - theta^2/48
    k = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    qw = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half))
    return quat_normalize(jnp.concatenate([qw, k * w], axis=-1))


def so3_log(q: Array) -> Array:
    """Unit quaternion (...,4) → axis-angle (...,3). Taylor-safe near id."""
    q = jnp.where(q[..., :1] < 0, -q, q)  # shortest arc
    qw = jnp.clip(q[..., :1], -1.0, 1.0)
    qv = q[..., 1:4]
    sin_half = jnp.linalg.norm(qv, axis=-1, keepdims=True)
    half = jnp.arctan2(sin_half, qw)
    small = sin_half < 1e-6
    k = jnp.where(small, 2.0 / jnp.maximum(qw, _EPS), 2.0 * half / jnp.maximum(sin_half, _EPS))
    return k * qv


def _so3_left_jacobian_terms(theta2: Array):
    """Coefficients (A, B) with V = I + A [w]x + B [w]x^2 (left Jacobian)."""
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    small = theta2 < 1e-8
    A = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    B = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta)
    )
    return A, B


def _skew(w: Array) -> Array:
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    m = jnp.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------


def compose(a: Array, b: Array) -> Array:
    """T_A_C = T_A_B ∘ T_B_C."""
    q = quat_mul(rotation(a), rotation(b))
    t = quat_rotate(rotation(a), translation(b)) + translation(a)
    return make(quat_normalize(q), t)


def inverse(T: Array) -> Array:
    qi = quat_conj(rotation(T))
    return make(qi, -quat_rotate(qi, translation(T)))


def transform_points(T: Array, p: Array) -> Array:
    """Apply T to points p (...,3); T broadcasts against p's batch dims."""
    return quat_rotate(rotation(T), p) + translation(T)


def se3_exp(xi: Array) -> Array:
    """Tangent (...,6) [w, v] → transform (...,7)."""
    w, v = xi[..., :3], xi[..., 3:6]
    q = so3_exp(w)
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)
    A, B = _so3_left_jacobian_terms(theta2)
    W = _skew(w)
    Vv = (
        v
        + A * jnp.einsum("...ij,...j->...i", W, v, precision=_HI)
        + B * jnp.einsum("...ij,...jk,...k->...i", W, W, v, precision=_HI)
    )
    return make(q, Vv)


def se3_log(T: Array) -> Array:
    """Transform (...,7) → tangent (...,6) [w, v]."""
    w = so3_log(rotation(T))
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)
    A, B = _so3_left_jacobian_terms(theta2)
    W = _skew(w)
    # V^{-1} = I - 1/2 [w]x + C [w]x^2,  C = (1 - A/(2B')) ... use closed form:
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    small = theta2 < 1e-8
    half = 0.5 * theta
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.maximum(jnp.sin(half), _EPS)) / theta2,
    )
    t = translation(T)
    v = (
        t
        - 0.5 * jnp.einsum("...ij,...j->...i", W, t, precision=_HI)
        + cot_term * jnp.einsum("...ij,...jk,...k->...i", W, W, t,
                                precision=_HI)
    )
    return jnp.concatenate([w, v], axis=-1)


def to_matrix(T: Array) -> Array:
    """(...,7) → homogeneous (...,4,4)."""
    R = quat_to_matrix(rotation(T))
    t = translation(T)[..., :, None]
    top = jnp.concatenate([R, t], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0, 0, 1.0], dtype=T.dtype), T.shape[:-1] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def from_matrix(M: Array) -> Array:
    return make(matrix_to_quat(M[..., :3, :3]), M[..., :3, 3])


# ---------------------------------------------------------------------------
# 4-DoF (x, y, z, yaw) — reference backend/node_collection.h:21-25
# ---------------------------------------------------------------------------


def from_xyzyaw(p: Array) -> Array:
    """4-DoF pose (...,4) [x,y,z,yaw] → transform (...,7)."""
    yaw = p[..., 3]
    half = 0.5 * yaw
    q = jnp.stack(
        [jnp.cos(half), jnp.zeros_like(half), jnp.zeros_like(half), jnp.sin(half)],
        axis=-1,
    )
    return make(q, p[..., :3])


def to_xyzyaw(T: Array) -> Array:
    """Project a transform to 4-DoF [x,y,z,yaw] (drops roll/pitch)."""
    q = rotation(T)
    yaw = jnp.arctan2(
        2.0 * (q[..., 0] * q[..., 3] + q[..., 1] * q[..., 2]),
        1.0 - 2.0 * (q[..., 2] ** 2 + q[..., 3] ** 2),
    )
    return jnp.concatenate([translation(T), yaw[..., None]], axis=-1)


# ---------------------------------------------------------------------------
# Interpolation & pose histories
# ---------------------------------------------------------------------------


def interpolate(Ta: Array, Tb: Array, alpha: Array) -> Array:
    """Componentwise interpolation: lerp translation + slerp rotation.

    Matches the reference's kindr::interpolateComponentwise use for
    same-stamp pose averaging (submap_collection.h:95-144)."""
    alpha = jnp.asarray(alpha)[..., None]
    qa, qb = rotation(Ta), rotation(Tb)
    dot = jnp.sum(qa * qb, axis=-1, keepdims=True)
    qb = jnp.where(dot < 0, -qb, qb)
    dot = jnp.abs(dot)
    # slerp with nlerp fallback for nearly-parallel quats
    theta = jnp.arccos(jnp.clip(dot, -1.0, 1.0))
    sin_theta = jnp.sin(theta)
    near = sin_theta < 1e-5
    wa = jnp.where(near, 1.0 - alpha, jnp.sin((1.0 - alpha) * theta) / jnp.maximum(sin_theta, _EPS))
    wb = jnp.where(near, alpha, jnp.sin(alpha * theta) / jnp.maximum(sin_theta, _EPS))
    q = quat_normalize(wa * qa + wb * qb)
    t = (1.0 - alpha) * translation(Ta) + alpha * translation(Tb)
    return make(q, t)


def lookup_pose(stamps: Array, poses: Array, t: Array) -> Array:
    """Interpolated pose at time t from a timestamped history.

    stamps: (N,) sorted times, poses: (N,7). t clamped to [stamps0, stampsN].
    Replaces voxgraph lookupPoseByTime (used at coxgraph_client.cpp:53-57)."""
    idx = jnp.clip(jnp.searchsorted(stamps, t, side="right"), 1, stamps.shape[0] - 1)
    t0, t1 = stamps[idx - 1], stamps[idx]
    alpha = jnp.clip((t - t0) / jnp.maximum(t1 - t0, _EPS), 0.0, 1.0)
    return interpolate(poses[idx - 1], poses[idx], alpha)


def relative(Ta: Array, Tb: Array) -> Array:
    """T_A_B = Ta^{-1} ∘ Tb."""
    return compose(inverse(Ta), Tb)


def _np_quat_mul(a, b):
    import numpy as np
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=-1)


def _np_quat_rotate(q, v):
    import numpy as np
    qw = q[..., :1]
    qv = q[..., 1:4]
    uv = np.cross(qv, v)
    uuv = np.cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def identity_np(dtype=None):
    """NumPy twin of identity() — host-side control code."""
    import numpy as np
    return np.array([1.0, 0, 0, 0, 0, 0, 0], dtype or np.float32)


def compose_np(a, b):
    """NumPy twin of compose() for host-side control code (no eager
    device ops in bookkeeping loops — utils/hostops)."""
    import numpy as np
    a = np.asarray(a)
    b = np.asarray(b)
    q = _np_quat_mul(a[..., :4], b[..., :4])
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), _EPS)
    t = _np_quat_rotate(a[..., :4], b[..., 4:7]) + a[..., 4:7]
    return np.concatenate([q, t], axis=-1)


def inverse_np(T):
    import numpy as np
    T = np.asarray(T)
    qi = T[..., :4] * np.array([1.0, -1, -1, -1], T.dtype)
    return np.concatenate(
        [qi, -_np_quat_rotate(qi, T[..., 4:7])], axis=-1)


def relative_np(Ta, Tb):
    return compose_np(inverse_np(Ta), Tb)


def transform_points_np(T, p):
    """NumPy twin of transform_points(): T (7,) applied to p (...,3)."""
    import numpy as np
    T = np.asarray(T)
    p = np.asarray(p)
    return _np_quat_rotate(T[None, :4], p) + T[None, 4:7]


def lookup_pose_np(stamps, poses, t: float):
    """Pure-NumPy lookup_pose for host-side control code — every eager
    device op with a new shape/constant compiles a fresh program (see
    utils/hostops), so server-side bookkeeping interpolates on the host."""
    import numpy as np

    stamps = np.asarray(stamps)
    poses = np.asarray(poses)
    idx = int(np.clip(np.searchsorted(stamps, t, side="right"), 1,
                      len(stamps) - 1))
    t0, t1 = stamps[idx - 1], stamps[idx]
    a = float(np.clip((t - t0) / max(t1 - t0, 1e-9), 0.0, 1.0))
    qa, qb = poses[idx - 1, :4], poses[idx, :4]
    if np.dot(qa, qb) < 0:
        qb = -qb
    dot = np.clip(abs(np.dot(qa, qb)), -1.0, 1.0)
    theta = np.arccos(dot)
    if np.sin(theta) < 1e-5:
        q = (1 - a) * qa + a * qb
    else:
        q = (np.sin((1 - a) * theta) * qa + np.sin(a * theta) * qb) \
            / np.sin(theta)
    q = q / max(np.linalg.norm(q), 1e-9)
    tr = (1 - a) * poses[idx - 1, 4:] + a * poses[idx, 4:]
    return np.concatenate([q, tr]).astype(np.float32)
