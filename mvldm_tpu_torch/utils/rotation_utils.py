"""Rotation conversions + isotropic Gaussian on SO(3).

Numpy re-creation of the parts of reference ``src/misc/rotation_utils.py``
that the live config surface can reach (the ``IsotropicGaussianSO3``
distribution drives ``random_transform_shim``; conversions support it).
Angle sampling uses the truncated series expansion of the IGSO(3) density
with inverse-CDF sampling, matching the reference's distribution rather than
its torch autograd plumbing.
"""

from __future__ import annotations

import numpy as np


def hat(v: np.ndarray) -> np.ndarray:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrices."""
    out = np.zeros(v.shape[:-1] + (3, 3), dtype=v.dtype)
    out[..., 0, 1] = -v[..., 2]
    out[..., 0, 2] = v[..., 1]
    out[..., 1, 0] = v[..., 2]
    out[..., 1, 2] = -v[..., 0]
    out[..., 2, 0] = -v[..., 1]
    out[..., 2, 1] = v[..., 0]
    return out


def axis_angle_to_matrix(axis_angle: np.ndarray) -> np.ndarray:
    """Rodrigues formula; axis_angle (..., 3) with magnitude = angle."""
    angle = np.linalg.norm(axis_angle, axis=-1, keepdims=True)
    safe = np.where(angle < 1e-12, 1.0, angle)
    axis = axis_angle / safe
    k = hat(axis)
    eye = np.broadcast_to(np.eye(3), k.shape)
    s = np.sin(angle)[..., None]
    c = np.cos(angle)[..., None]
    return eye + s * k + (1.0 - c) * (k @ k)


def matrix_to_axis_angle(rot: np.ndarray) -> np.ndarray:
    """Inverse Rodrigues; returns (..., 3)."""
    trace = np.trace(rot, axis1=-2, axis2=-1)
    angle = np.arccos(np.clip((trace - 1.0) / 2.0, -1.0, 1.0))
    axis = np.stack(
        [
            rot[..., 2, 1] - rot[..., 1, 2],
            rot[..., 0, 2] - rot[..., 2, 0],
            rot[..., 1, 0] - rot[..., 0, 1],
        ],
        axis=-1,
    )
    norm = np.linalg.norm(axis, axis=-1, keepdims=True)
    axis = axis / np.where(norm < 1e-12, 1.0, norm)
    return axis * angle[..., None]


def quaternion_to_matrix(quat: np.ndarray) -> np.ndarray:
    """(w, x, y, z) quaternions -> rotation matrices."""
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    n = w * w + x * x + y * y + z * z
    s = 2.0 / np.where(n < 1e-12, 1.0, n)
    out = np.empty(quat.shape[:-1] + (3, 3), dtype=quat.dtype)
    out[..., 0, 0] = 1 - s * (y * y + z * z)
    out[..., 0, 1] = s * (x * y - z * w)
    out[..., 0, 2] = s * (x * z + y * w)
    out[..., 1, 0] = s * (x * y + z * w)
    out[..., 1, 1] = 1 - s * (x * x + z * z)
    out[..., 1, 2] = s * (y * z - x * w)
    out[..., 2, 0] = s * (x * z - y * w)
    out[..., 2, 1] = s * (y * z + x * w)
    out[..., 2, 2] = 1 - s * (x * x + y * y)
    return out


def matrix_to_quaternion(rot: np.ndarray) -> np.ndarray:
    """Rotation matrices -> (w, x, y, z) quaternions (single matrix or batch)."""
    rot = np.asarray(rot)
    single = rot.ndim == 2
    if single:
        rot = rot[None]
    m = rot
    q = np.empty((m.shape[0], 4), dtype=m.dtype)
    t = np.trace(m, axis1=-2, axis2=-1)
    for i in range(m.shape[0]):
        if t[i] > 0:
            r = np.sqrt(1 + t[i])
            s = 0.5 / r
            q[i] = [
                0.5 * r,
                (m[i, 2, 1] - m[i, 1, 2]) * s,
                (m[i, 0, 2] - m[i, 2, 0]) * s,
                (m[i, 1, 0] - m[i, 0, 1]) * s,
            ]
        else:
            j = np.argmax(np.diag(m[i]))
            a, b, c = j, (j + 1) % 3, (j + 2) % 3
            r = np.sqrt(1 + m[i, a, a] - m[i, b, b] - m[i, c, c])
            s = 0.5 / r
            qv = np.empty(3)
            qv[a] = 0.5 * r
            qv[b] = (m[i, a, b] + m[i, b, a]) * s
            qv[c] = (m[i, c, a] + m[i, a, c]) * s
            q[i] = [(m[i, c, b] - m[i, b, c]) * s, *qv]
    return q[0] if single else q


def igso3_density(angle: np.ndarray, eps: float, terms: int = 50) -> np.ndarray:
    """IGSO(3) marginal angle density f(w) ~ sum_l (2l+1) exp(-l(l+1) eps^2)
    sin((l+1/2)w)/sin(w/2) * (1-cos w)/pi, truncated."""
    angle = np.asarray(angle, dtype=np.float64)
    small = np.maximum(np.sin(angle / 2.0), 1e-12)
    total = np.zeros_like(angle)
    for l in range(terms):
        total += (
            (2 * l + 1)
            * np.exp(-l * (l + 1) * eps**2)
            * np.sin((l + 0.5) * angle)
            / small
        )
    return np.maximum(total * (1.0 - np.cos(angle)) / np.pi, 0.0)


class IsotropicGaussianSO3:
    """Isotropic Gaussian on SO(3) with concentration ``eps`` (reference
    ``rotation_utils.py``); samples rotation matrices."""

    def __init__(self, eps: float, num_bins: int = 2048):
        self.eps = float(eps)
        self._angles = np.linspace(1e-5, np.pi, num_bins)
        pdf = igso3_density(self._angles, self.eps)
        cdf = np.cumsum(pdf)
        self._cdf = cdf / cdf[-1]

    def sample_angle(self, rng: np.random.Generator, n: int = 1) -> np.ndarray:
        u = rng.uniform(size=n)
        return np.interp(u, self._cdf, self._angles)

    def sample(self, rng: np.random.Generator, n: int = 1) -> np.ndarray:
        angles = self.sample_angle(rng, n)
        axes = rng.normal(size=(n, 3))
        axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
        return axis_angle_to_matrix(axes * angles[:, None])
