"""World: chunk store with spherical view-distance streaming.

Host-side scene management (the reference's is host-side too —
src/world.rs).  Chunk voxel payloads live in numpy and are uploaded to the
device quad pool by the meshing/cache layer; the World itself only manages
generation, streaming, and visibility queries.

Reference: src/world.rs
- WorldConfig{view_distance, frustum_culling, max_chunks_per_frame}: :10-27
- update() — budgeted generation + hysteresis unload (vd + 2): :57-100
- get_visible_chunks[_frustum] — sphere + optional frustum: :103-146
- generate_region / contains_chunk / set_view_distance: :159-196
"""

from __future__ import annotations

import collections
from dataclasses import dataclass

import numpy as np

from ..utils import profiling as prof
from ..utils.config import CHUNK_SIZE
from .camera import Frustum
from .chunk import Chunk


@dataclass
class WorldConfig:
    view_distance: int = 8
    frustum_culling: bool = True
    max_chunks_per_frame: int = 4


def world_to_chunk_pos(world_pos) -> tuple[int, int, int]:
    """World position -> chunk grid position (src/world.rs:201-207)."""
    p = np.asarray(world_pos, dtype=np.float32)
    return tuple(int(v) for v in np.floor(p / CHUNK_SIZE).astype(np.int64))


def chunk_bounds(chunk_pos) -> tuple[np.ndarray, np.ndarray]:
    """Chunk AABB in world space (src/world.rs:211-215)."""
    mn = np.asarray(chunk_pos, dtype=np.float32) * CHUNK_SIZE
    return mn, mn + np.float32(CHUNK_SIZE)


class World:
    def __init__(self, config: WorldConfig | None = None):
        self.config = config or WorldConfig()
        self.chunks: dict[tuple[int, int, int], Chunk] = {}
        self.last_camera_chunk: tuple[int, int, int] | None = None
        # (keys list, position array, count) — appends are incremental
        # (streaming adds ~16/frame; a full rebuild of a 7k-entry tuple
        # array costs ~3 ms and dominated moving-camera frames)
        self._pos_cache: tuple[list, np.ndarray, int] | None = None
        # camera chunk at which the view sphere was last found complete;
        # skips the O(candidates) generation scan on static frames
        self._filled_at: tuple[int, int, int] | None = None
        # mid-fill missing-candidate queue: the vectorized sphere scan
        # depends only on (camera chunk, chunk-set version), so while the
        # camera stays in one chunk the per-frame scan (meshgrid + isin
        # over ~15k candidates, ~0.7 ms at vd12) runs ONCE and streaming
        # frames just pop their budget from the queue
        self._missing_queue: object | None = None  # collections.deque
        self._missing_at: tuple[int, int, int] | None = None
        self._queue_version = -1
        self._sphere_offsets: dict[int, np.ndarray] = {}  # vd -> offsets
        # monotonically increasing mutation counter (chunk set changes);
        # callers key caches off it (the engine skips remesh scans /
        # cache retention when nothing changed)
        self.version = 0
        # bumped ONLY when chunks are unloaded: mesh-cache retention
        # (engine: pool.retain) only matters after an unload, and
        # streaming frames bump `version` every frame — keying retention
        # off this counter removes an O(pool) Python scan per streaming
        # frame (the reference's retain runs per frame, main.rs:280, but
        # its HashMap::retain is native; ours was ~0.4 ms of Python)
        self.unload_version = 0
        # opt-in add log (resident engine): positions streamed in since
        # the last drain_added().  Off by default so long-lived
        # non-resident worlds don't accumulate an unbounded list.
        self.track_added = False
        self._added_log: list = []

    # -------------------------------------------------------------- access
    def get_or_generate_chunk(self, chunk_pos) -> Chunk:
        key = tuple(int(c) for c in chunk_pos)
        if key not in self.chunks:
            with prof.WORLD_GENERATE:
                self.chunks[key] = Chunk.generate_terrain(key)
                self._note_add(key)
                prof.CHUNKS_GENERATED.add(1)
        return self.chunks[key]

    def contains_chunk(self, position) -> bool:
        return tuple(int(c) for c in position) in self.chunks

    def chunk_count(self) -> int:
        return len(self.chunks)

    def get_all_chunks(self) -> list[Chunk]:
        return list(self.chunks.values())

    def clear(self) -> None:
        self.chunks.clear()
        self.last_camera_chunk = None
        self._filled_at = None
        self._invalidate_cache()
        self.unload_version += 1

    def set_view_distance(self, view_distance: int) -> None:
        self.config.view_distance = max(1, int(view_distance))
        self._filled_at = None
        self._missing_queue = None  # queue was built for the old sphere

    def view_distance(self) -> int:
        return self.config.view_distance

    # ----------------------------------------------------------- streaming
    def update(self, camera_position) -> bool:
        """Stream in up to ``max_chunks_per_frame`` chunks inside the view
        sphere; unload beyond vd + 2 (hysteresis).  Returns True if any chunk
        was generated (src/world.rs:57-100).

        The candidate scan is vectorized: the cube of candidate positions is
        produced with numpy and filtered by the sphere + membership test
        instead of a triple Python loop.
        """
        with prof.WORLD_UPDATE:
            cam = world_to_chunk_pos(camera_position)
            self.last_camera_chunk = cam
            if self._filled_at == cam:
                return False  # sphere already filled at this camera chunk

            if (self._missing_at != cam or self._queue_version != self.version
                    or self._missing_queue is None):
                with prof.WORLD_QUEUE:
                    self._queue_missing(cam)

            queue = self._missing_queue
            generated = 0
            # budget floor of 1 preserves the pre-queue semantics (the old
            # loop generated a chunk BEFORE checking the budget, so even
            # max_chunks_per_frame <= 0 made progress each frame)
            budget = max(1, self.config.max_chunks_per_frame)
            with prof.WORLD_GENERATE:
                while queue and generated < budget:
                    pos = queue.popleft()
                    # paranoia vs pack collisions / ext adds
                    if pos not in self.chunks:
                        self.chunks[pos] = Chunk.generate_terrain(pos)
                        self._note_add(pos)
                        generated += 1
                prof.CHUNKS_GENERATED.add(generated)
            if queue and generated >= budget:
                self._queue_version = self.version
                return True

            with prof.WORLD_UNLOAD:
                unload = self.config.view_distance + 2
                unload_sq = float(unload * unload)
                before = len(self.chunks)
                self.chunks = {
                    pos: c
                    for pos, c in self.chunks.items()
                    if float((pos[0] - cam[0]) ** 2 + (pos[1] - cam[1]) ** 2
                             + (pos[2] - cam[2]) ** 2)
                    <= unload_sq
                }
                if len(self.chunks) != before:
                    self._invalidate_cache()
                    self.unload_version += 1
            if generated == 0:
                self._filled_at = cam
            self._queue_version = self.version
            return generated > 0

    def _queue_missing(self, cam) -> None:
        """Queue the view sphere's missing chunks around chunk ``cam``."""
        vd = self.config.view_distance
        offs = self._sphere_offsets.get(vd)
        if offs is None:
            r = np.arange(-vd, vd + 1, dtype=np.int64)
            gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
            offs = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
            dist_sq = (offs.astype(np.float32) ** 2).sum(-1)
            offs = offs[dist_sq <= float(vd * vd)]
            self._sphere_offsets[vd] = offs
        # Reference iterates x-outer / y / z-inner (world.rs:66-68);
        # meshgrid(indexing="ij") preserves that order.
        #
        # Vectorized missing-scan: a Python membership loop over the
        # ~7k-candidate sphere cost ~5 ms per streaming frame.  Both
        # sides pack (x, y, z) into one int64 (21 bits per axis) and
        # one np.isin finds the missing candidates in reference
        # order.  The result is QUEUED: it depends only on (camera
        # chunk, chunk-set version), so subsequent frames in the same
        # chunk pop their budget instead of rescanning.
        cand = offs + np.asarray(cam, dtype=np.int64)
        _, loaded = self._positions_array()

        def pack(a):
            m = np.int64(0x1FFFFF)
            return (((a[:, 0] & m) << 42) | ((a[:, 1] & m) << 21)
                    | (a[:, 2] & m))

        if len(loaded):
            missing = ~np.isin(pack(cand), pack(loaded),
                               assume_unique=False)
        else:
            missing = np.ones(len(cand), dtype=bool)
        self._missing_queue = collections.deque(
            map(tuple, cand[missing].tolist()))
        self._missing_at = cam

    # ---------------------------------------------------------- visibility
    def _positions_array(self) -> tuple[list[tuple[int, int, int]], np.ndarray]:
        """Cached key/position arrays; appends maintain them in place.
        A float32 world-space AABB-min array rides along for the frustum
        test (recomputing int64 -> f32 * CHUNK_SIZE per frame cost ~1 ms
        at 8k chunks)."""
        if self._pos_cache is None:
            keys = list(self.chunks.keys())
            n = len(keys)
            cap = max(64, 2 * n)
            arr = np.zeros((cap, 3), dtype=np.int64)
            if n:
                arr[:n] = np.fromiter(
                    (c for k in keys for c in k), dtype=np.int64,
                    count=3 * n).reshape(n, 3)
            minsf = arr.astype(np.float32) * CHUNK_SIZE
            self._pos_cache = (keys, arr, n, minsf)
        keys, arr, n, _ = self._pos_cache
        return keys, arr[:n]

    def _mins_f32(self) -> np.ndarray:
        self._positions_array()
        keys, arr, n, minsf = self._pos_cache
        return minsf[:n]

    def drain_added(self) -> list:
        """Positions streamed in since the last drain (``track_added``
        must be on — the resident engine's incremental remesh scan; the
        full sphere scan cost ~0.8 ms per streaming frame)."""
        out, self._added_log = self._added_log, []
        return out

    def _note_add(self, key) -> None:
        """O(1) cache maintenance for a streamed-in chunk."""
        self.version += 1
        if self.track_added:
            self._added_log.append(key)
        if self._pos_cache is None:
            return
        keys, arr, n, minsf = self._pos_cache
        if n >= arr.shape[0]:
            arr = np.resize(arr, (2 * arr.shape[0], 3))
            minsf = np.resize(minsf, (2 * minsf.shape[0], 3))
        arr[n] = key
        minsf[n] = np.asarray(key, np.float32) * CHUNK_SIZE
        keys.append(key)
        self._pos_cache = (keys, arr, n + 1, minsf)

    def _invalidate_cache(self) -> None:
        self._pos_cache = None
        self.version += 1

    def get_visible_chunks(self, camera_position) -> list[Chunk]:
        """Sphere-only visibility (src/world.rs:103-114), vectorized."""
        cam = np.asarray(world_to_chunk_pos(camera_position), dtype=np.int64)
        keys, pos = self._positions_array()
        if not keys:
            return []
        dist_sq = ((pos - cam) ** 2).sum(-1).astype(np.float32)
        vd_sq = np.float32(self.config.view_distance**2)
        return [self.chunks[keys[i]] for i in np.nonzero(dist_sq <= vd_sq)[0]]

    def get_visible_positions(self, camera_position,
                              frustum: Frustum | None) -> np.ndarray:
        """Sphere + optional frustum AABB visibility (src/world.rs:118-146),
        vectorized over the whole chunk table in one pass.  Returns the
        visible chunk POSITIONS as int64[V, 3] in table order — the
        allocation-free form the per-frame funnel consumes (building a
        Python Chunk list cost ~0.55 ms at vd12; see
        get_visible_chunks_frustum for the object-returning wrapper)."""
        cam = np.asarray(world_to_chunk_pos(camera_position), dtype=np.int64)
        keys, pos = self._positions_array()
        if not keys:
            return np.zeros((0, 3), np.int64)
        # f32 distance: chunk-grid deltas are small integers, so squares
        # and sums are exact — identical keep mask, ~3x cheaper than int64
        mins = self._mins_f32()
        d = mins * np.float32(1.0 / CHUNK_SIZE) - cam.astype(np.float32)
        dist_sq = np.einsum("ij,ij->i", d, d)
        keep = dist_sq <= np.float32(self.config.view_distance**2)
        if self.config.frustum_culling and frustum is not None:
            keep &= frustum.inside_mins(mins, float(CHUNK_SIZE))
        return pos[keep]

    def get_visible_chunks_frustum(
        self, camera_position, frustum: Frustum | None
    ) -> list[Chunk]:
        """Object-returning wrapper over :meth:`get_visible_positions`
        (API parity with the reference's Vec<&Chunk> return)."""
        vis = self.get_visible_positions(camera_position, frustum)
        return [self.chunks[(int(p[0]), int(p[1]), int(p[2]))]
                for p in vis]

    # ------------------------------------------------------------- helpers
    def generate_region(self, mins, maxs) -> None:
        """Pre-generate an inclusive region (src/world.rs:159-170)."""
        with prof.WORLD_GENERATE:
            for cx in range(int(mins[0]), int(maxs[0]) + 1):
                for cy in range(int(mins[1]), int(maxs[1]) + 1):
                    for cz in range(int(mins[2]), int(maxs[2]) + 1):
                        key = (cx, cy, cz)
                        if key not in self.chunks:
                            self.chunks[key] = Chunk.generate_terrain(key)
                            self._note_add(key)
                            prof.CHUNKS_GENERATED.add(1)
