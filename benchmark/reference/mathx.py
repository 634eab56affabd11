# Frozen copy of differential_projection_voxel_renderer_tpu_torch/utils/mathx.py
# at commit 1521963, imports made local; the yardstick keeps it as it
# is, so that a later change to the program cannot move it.
"""Small matrix/vector helpers (numpy, f32) matching glam's conventions.

The Rust reference uses glam (column-major ``Mat4`` acting on column
vectors, right-handed, 0..1 depth range for ``perspective_rh``).  We keep
plain ``numpy`` 4x4 arrays with the standard mathematical layout so that
``clip = M @ [x, y, z, 1]``.

Reference citations:
- Camera matrices:  src/camera/mod.rs:44-61
- glam perspective_rh / look_at_rh semantics (0..1 clip z, RH)
"""

from __future__ import annotations

import numpy as np


def normalize(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=np.float32)
    n = np.linalg.norm(v)
    return v / np.float32(n)


def cross3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """3-vector cross product, same formula (and f32 results) as
    ``np.cross`` but without its ~50 us of moveaxis/broadcast machinery —
    ``np.cross`` was the single hottest host-frame cost at 6 calls/frame
    (measured via cProfile; see camera caching note)."""
    return np.array([a[1] * b[2] - a[2] * b[1],
                     a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]], dtype=np.float32)


def perspective_rh(fov_y: float, aspect: float, near: float, far: float) -> np.ndarray:
    """glam Mat4::perspective_rh — right handed, clip z in [0, 1]."""
    f32 = np.float32
    sin_fov = f32(np.sin(0.5 * fov_y))
    cos_fov = f32(np.cos(0.5 * fov_y))
    h = f32(cos_fov / sin_fov)
    w = f32(h / aspect)
    r = f32(far / (near - far))
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = r
    m[2, 3] = f32(r * near)
    m[3, 2] = f32(-1.0)
    return m


def look_at_rh(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """glam Mat4::look_at_rh."""
    eye = np.asarray(eye, dtype=np.float32)
    f = normalize(np.asarray(center, dtype=np.float32) - eye)  # forward
    s = normalize(cross3(f, np.asarray(up, dtype=np.float32)))
    u = cross3(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(eye, s)
    m[1, 3] = -np.dot(eye, u)
    m[2, 3] = np.dot(eye, f)
    return m


def rot_y(angle: float) -> np.ndarray:
    c, s = np.float32(np.cos(angle)), np.float32(np.sin(angle))
    m = np.eye(3, dtype=np.float32)
    m[0, 0] = c
    m[0, 2] = s
    m[2, 0] = -s
    m[2, 2] = c
    return m


def rot_x(angle: float) -> np.ndarray:
    c, s = np.float32(np.cos(angle)), np.float32(np.sin(angle))
    m = np.eye(3, dtype=np.float32)
    m[1, 1] = c
    m[1, 2] = -s
    m[2, 1] = s
    m[2, 2] = c
    return m


def transform_point(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    """clip = M @ [p, 1] (f32)."""
    p4 = np.array([p[0], p[1], p[2], 1.0], dtype=np.float32)
    return (m.astype(np.float32) @ p4).astype(np.float32)


def transform_vector(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """clip = M @ [v, 0] (f32) — direction transform, used by FaceBasis
    (reference: src/rendering/differential_projection.rs:50-53)."""
    v4 = np.array([v[0], v[1], v[2], 0.0], dtype=np.float32)
    return (m.astype(np.float32) @ v4).astype(np.float32)
