# Frozen copy of differential_projection_voxel_renderer_tpu_torch/models/perlin.py
# at commit 1521963, imports made local; the yardstick keeps it as it
# is, so that a later change to the program cannot move it.
"""Seeded 2-D Perlin noise, vectorized with numpy.

Reimplements the algorithm used by the Rust reference's terrain generator
(``noise::Perlin::new(12345)`` from the `noise` crate v0.9.0; see
reference src/voxel/chunk.rs:114-177):

- a 256-entry permutation table built with a Fisher-Yates shuffle driven by
  ``rand_xorshift::XorShiftRng`` seeded with bytes ``[1, seed_le..., 0...]``
  (noise-rs ``PermutationTable::new`` — the leading 1 guards the
  all-zero-seed case), sampling indices with rand 0.8's ``sample_single``
  widening-multiply rejection,
- hashing ``hash(x, y) = values[values[x & 255] ^ (y & 255)]``,
- four diagonal gradients selected by ``hash & 3``
  (``(1,1), (-1,1), (1,-1), (-1,-1)``),
- quintic fade ``t^3 (t (6 t - 15) + 10)``,
- output scaled by ``2 / sqrt(2)`` and clamped to ``[-1, 1]``.

The Rust `noise` crate source is not vendored in this environment, so the
RNG/table construction follows the published crate algorithm as documented
above; the generator is deterministic, seeded, and structurally identical.
The whole sampler is vectorized: pass arrays of x/y coordinates and get an
array of noise values back (the reference samples one point per call,
src/voxel/chunk.rs:173-177 — here one call covers a whole 32x32 column grid).
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_MASK32 = 0xFFFFFFFF


class _XorShiftRng:
    """rand_xorshift::XorShiftRng — Marsaglia xor128.

    ``from_seed`` reads 16 little-endian bytes into (x, y, z, w) and maps
    the all-zero seed to 4x 0x0BAD_5EED (rand_xorshift lib.rs).
    """

    def __init__(self, seed_bytes: bytes):
        assert len(seed_bytes) == 16
        words = [int.from_bytes(seed_bytes[i:i + 4], "little")
                 for i in range(0, 16, 4)]
        if all(w == 0 for w in words):
            words = [0x0BAD5EED] * 4
        self.x, self.y, self.z, self.w = words

    def next_u32(self) -> int:
        t = (self.x ^ ((self.x << 11) & _MASK32)) & _MASK32
        self.x, self.y, self.z = self.y, self.z, self.w
        w = self.w
        self.w = (w ^ (w >> 19) ^ (t ^ (t >> 8))) & _MASK32
        return self.w

    def gen_range(self, upper: int) -> int:
        """Uniform integer in [0, upper) exactly as rand 0.8's
        ``Rng::gen_range`` -> ``UniformInt<u32>::sample_single``: widening
        multiply with acceptance zone ``(range << range.leading_zeros())
        - 1`` (uniform_int_impl; NOT the ``ints_to_reject`` zone of the
        prebuilt-distribution path — the two reject different words and so
        consume different streams)."""
        range_ = upper & _MASK32
        lz = 32 - range_.bit_length()
        zone = ((range_ << lz) - 1) & _MASK32
        while True:
            v = self.next_u32()
            m = v * range_
            lo = m & _MASK32
            if lo <= zone:
                return m >> 32


def _permutation_table(seed: int) -> np.ndarray:
    # noise-rs PermutationTable::new(seed): seed bytes [1, b0, b1, b2, b3,
    # 0 x 11] — the leading 1 keeps the XorShift state nonzero for seed 0
    # — then Standard::sample shuffles an identity [0..=255] sequence.
    sb = (int(seed) & _MASK32).to_bytes(4, "little")
    rng = _XorShiftRng(bytes([1]) + sb + bytes(11))
    values = list(range(256))
    # rand 0.8 SliceRandom::shuffle — Fisher-Yates from the back; ubound
    # fits u32 so gen_index takes the 32-bit gen_range path.
    for i in range(255, 0, -1):
        j = rng.gen_range(i + 1)
        values[i], values[j] = values[j], values[i]
    return np.array(values, dtype=np.int64)


_SCALE_FACTOR = 2.0 / np.sqrt(2.0)


class Perlin:
    """Seeded 2-D Perlin sampler. ``get(x, y)`` accepts scalars or arrays."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._table = _permutation_table(self.seed)

    def _hash2(self, xi: np.ndarray, yi: np.ndarray) -> np.ndarray:
        t = self._table
        return t[t[xi & 0xFF] ^ (yi & 0xFF)]

    @staticmethod
    def _grad_dot(h: np.ndarray, dx: np.ndarray, dy: np.ndarray) -> np.ndarray:
        g = h & 0b11
        # 0 => x + y, 1 => -x + y, 2 => x - y, 3 => -x - y
        sx = np.where((g & 1) == 0, 1.0, -1.0)
        sy = np.where((g & 2) == 0, 1.0, -1.0)
        return sx * dx + sy * dy

    def get(self, x, y):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        fx = np.floor(x)
        fy = np.floor(y)
        cx = fx.astype(np.int64)
        cy = fy.astype(np.int64)
        dx = x - fx
        dy = y - fy

        g00 = self._grad_dot(self._hash2(cx, cy), dx, dy)
        g10 = self._grad_dot(self._hash2(cx + 1, cy), dx - 1.0, dy)
        g01 = self._grad_dot(self._hash2(cx, cy + 1), dx, dy - 1.0)
        g11 = self._grad_dot(self._hash2(cx + 1, cy + 1), dx - 1.0, dy - 1.0)

        u = dx * dx * dx * (dx * (dx * 6.0 - 15.0) + 10.0)
        v = dy * dy * dy * (dy * (dy * 6.0 - 15.0) + 10.0)

        k1 = g10 - g00
        k2 = g01 - g00
        k3 = g00 + g11 - g10 - g01
        unscaled = g00 + k1 * u + k2 * v + k3 * u * v
        return np.clip(unscaled * _SCALE_FACTOR, -1.0, 1.0)
