"""4x4 homogeneous transforms (counterpart of ``utils/transform.py``).

Builders compute in numpy exactly as the JAX package does (its builders are
numpy too, and so is the composition of a camera's matrices), then hand the
float32 matrices over as tensors on the requested device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .device import OnDevice


@dataclass(frozen=True)
class Transform(OnDevice):
    m: torch.Tensor  # (4,4) float32
    m_inv: torch.Tensor  # (4,4) float32

    def inverse(self) -> "Transform":
        return Transform(self.m_inv, self.m)

    def __matmul__(self, other: "Transform") -> "Transform":
        """Composition, computed in numpy float32 like the JAX package's
        host-side builders (the product is not re-associated on a card)."""
        dev = self.m.device
        a, ai = self.m.cpu().numpy(), self.m_inv.cpu().numpy()
        b, bi = other.m.cpu().numpy(), other.m_inv.cpu().numpy()
        return _make(a @ b, bi @ ai, dev)


def _make(m, mi, device):
    return Transform(torch.as_tensor(np.asarray(m, np.float32), device=device),
                     torch.as_tensor(np.asarray(mi, np.float32), device=device))


def identity(*, device) -> Transform:
    eye = np.eye(4, dtype=np.float32)
    return _make(eye, eye.copy(), device)


def from_matrix(m, *, device) -> Transform:
    m = np.asarray(m, np.float32).reshape(4, 4)
    return _make(m, np.linalg.inv(m).astype(np.float32), device)


def translate(dx, dy, dz, *, device) -> Transform:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [dx, dy, dz]
    mi = np.eye(4, dtype=np.float32)
    mi[:3, 3] = [-dx, -dy, -dz]
    return _make(m, mi, device)


def scale(sx, sy, sz, *, device) -> Transform:
    m = np.diag(np.array([sx, sy, sz, 1.0], np.float32))
    mi = np.diag(np.array([1.0 / sx, 1.0 / sy, 1.0 / sz, 1.0], np.float32))
    return _make(m, mi, device)


def rotate(angle_deg, axis, *, device) -> Transform:
    """Rotation by angle_deg about axis (pbrt Rotate), built in float64
    and rounded to float32 as the JAX package does."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    s, c = np.sin(np.radians(angle_deg)), np.cos(np.radians(angle_deg))
    m = np.eye(4, dtype=np.float64)
    x, y, z = a
    m[:3, :3] = [
        [x * x + (1 - x * x) * c, x * y * (1 - c) - z * s,
         x * z * (1 - c) + y * s],
        [x * y * (1 - c) + z * s, y * y + (1 - y * y) * c,
         y * z * (1 - c) - x * s],
        [x * z * (1 - c) - y * s, y * z * (1 - c) + x * s,
         z * z + (1 - z * z) * c],
    ]
    return _make(m.astype(np.float32), m.T.astype(np.float32), device)


def look_at(eye, look, up, *, device) -> Transform:
    """Camera-to-world transform (pbrt LookAt: left-handed, +z view)."""
    eye = np.asarray(eye, np.float64)
    look = np.asarray(look, np.float64)
    up = np.asarray(up, np.float64)
    d = look - eye
    d = d / np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    nr = np.linalg.norm(right)
    if nr < 1e-8:
        raise ValueError("LookAt: up vector parallel to viewing direction")
    right /= nr
    new_up = np.cross(d, right)
    c2w = np.eye(4, dtype=np.float64)
    c2w[:3, 0] = right
    c2w[:3, 1] = new_up
    c2w[:3, 2] = d
    c2w[:3, 3] = eye
    return _make(c2w.astype(np.float32),
                 np.linalg.inv(c2w).astype(np.float32), device)


def perspective(fov_deg, z_near=1e-2, z_far=1000.0, *, device) -> Transform:
    """Camera-to-NDC perspective projection (pbrt Perspective)."""
    persp = np.array(
        [[1, 0, 0, 0],
         [0, 1, 0, 0],
         [0, 0, z_far / (z_far - z_near), -z_far * z_near / (z_far - z_near)],
         [0, 0, 1, 0]], np.float64)
    inv_tan = 1.0 / np.tan(np.radians(fov_deg) / 2.0)
    s = np.diag([inv_tan, inv_tan, 1.0, 1.0])
    return from_matrix(s @ persp, device=device)


def orthographic(z_near=0.0, z_far=1.0, *, device) -> Transform:
    """Camera-to-NDC orthographic projection (pbrt Orthographic)."""
    return (scale(1.0, 1.0, 1.0 / (z_far - z_near), device=device)
            @ translate(0, 0, -z_near, device=device))


def apply_point(t: Transform, p):
    m = t.m
    xp = p[..., 0] * m[0, 0] + p[..., 1] * m[0, 1] + p[..., 2] * m[0, 2] + m[0, 3]
    yp = p[..., 0] * m[1, 0] + p[..., 1] * m[1, 1] + p[..., 2] * m[1, 2] + m[1, 3]
    zp = p[..., 0] * m[2, 0] + p[..., 1] * m[2, 1] + p[..., 2] * m[2, 2] + m[2, 3]
    wp = p[..., 0] * m[3, 0] + p[..., 1] * m[3, 1] + p[..., 2] * m[3, 2] + m[3, 3]
    out = torch.stack([xp, yp, zp], dim=-1)
    return torch.where(wp[..., None] == 1.0, out, out / wp[..., None])


def apply_vector(t: Transform, v):
    m = t.m
    return torch.stack([
        v[..., 0] * m[0, 0] + v[..., 1] * m[0, 1] + v[..., 2] * m[0, 2],
        v[..., 0] * m[1, 0] + v[..., 1] * m[1, 1] + v[..., 2] * m[1, 2],
        v[..., 0] * m[2, 0] + v[..., 1] * m[2, 1] + v[..., 2] * m[2, 2],
    ], dim=-1)


def apply_normal(t: Transform, n):
    """Normals transform by the inverse transpose."""
    mi = t.m_inv
    return torch.stack([
        n[..., 0] * mi[0, 0] + n[..., 1] * mi[1, 0] + n[..., 2] * mi[2, 0],
        n[..., 0] * mi[0, 1] + n[..., 1] * mi[1, 1] + n[..., 2] * mi[2, 1],
        n[..., 0] * mi[0, 2] + n[..., 1] * mi[1, 2] + n[..., 2] * mi[2, 2],
    ], dim=-1)
