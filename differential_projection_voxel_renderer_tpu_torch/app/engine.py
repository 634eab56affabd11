"""The frame loop in PyTorch: world streaming, the device mesh pool, the
culling funnel and the per-frame render call.

Counterpart of ``differential_projection_voxel_renderer_tpu/app/engine.py``
on its serial path (``render_frame``, also with
``RenderConfig.packed_raster``, ``two_pass_near_quads`` or
``temporal_hiz``), in frames-in-flight mode (``render_frame_pipelined`` /
``flush_pipeline``), in the one-frame-stale pool mode
(``stale_streaming``, ``DPVR_STALE_POOL=1``) and in the resident superset
stream mode (``resident_stream``, ``DPVR_RESIDENT=1``), with the runtime
toggles, ``prime_all`` and the warm-ups; and, on an engine built with
``mesh_cards``, several views of the scene a call over a mesh of cards
(``render_views``: each view through the funnel, all of them in one
sharded render, parallel/sharded_render.py ``ViewsRender``).  The host
logic (streaming, remeshing, the culling funnel, draw-list build, the
pool's host bookkeeping) is carried over as it is, on the port's own
copies of the host layers (``models``, ``meshing``, ``ops/culling.py``,
``ops/occlusion.py``, ``utils``); only the device calls change.  Every device tensor lives on the ``device`` the
engine was built with, the card unless the caller asks for the CPU.  With
``device_meshing`` a remesh batch of 4 chunks or more is meshed on the
device (ops/meshing_device.py) and its rows scattered into the pool there.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from dataclasses import dataclass, replace as dc_replace

import numpy as np
import torch

from ..meshing import native_bridge
from ..meshing.greedy import mesh_chunk
from ..models.camera import Camera, CameraController
from ..models.world import World, WorldConfig, world_to_chunk_pos
from ..ops.culling import (
    HorizonCullingConfig,
    horizon_cull_mask,
    sort_front_to_back,
)
from ..ops.occlusion import occlusion_pass, project_chunk_rects
from ..parallel.sharded_render import ViewsRender, make_mesh
from ..rendering.pipeline import (
    RESIDENT_APPEND_VCAP,
    RESIDENT_INSERT_FP,
    RESIDENT_INSERT_KP,
    RESIDENT_INSERT_MC,
    Renderer,
    apply_insert_payload,
    pack_append_meta,
    resident_append_cap,
    resolve_device,
)
from ..utils import profiling as prof
from ..utils.config import CHUNK_SIZE, QUADS_PER_CHUNK_CAP, RenderConfig


def _resident_budget() -> int:
    """``DPVR_RES_BUDGET``, the resident mode's chunks meshed a frame: at
    least 1, and RESIDENT_INSERT_KP when unset or not an integer.  A
    deliberate divergence: the reference takes ``int()`` of it as given, so
    0 or less never drains the stash and a non-integer raises at
    construction."""
    try:
        return max(1, int(os.environ.get("DPVR_RES_BUDGET",
                                         RESIDENT_INSERT_KP)))
    except ValueError:
        return RESIDENT_INSERT_KP


# the warm-ups' throwaway pool entry: a chunk position no world reaches
_THROWAWAY = (10**6, 10**6, 10**6)

# RenderConfig and WorldConfig are re-exported: a caller of the port builds
# an Engine naming this package only
__all__ = ["DrawList", "Engine", "FrameResult", "QuadPool", "RenderConfig",
           "ViewsResult", "WorldConfig"]


def _dir_counts(quads: np.ndarray) -> np.ndarray:
    """Per-face-direction counts of a packed quad array; meshes must be
    grouped by face direction (the mesher's emission order)."""
    if len(quads) == 0:
        return np.zeros(6, np.int32)
    d = (np.asarray(quads, np.uint32) >> 29) & 7
    assert (np.diff(d) >= 0).all(), "mesh quads not grouped by face dir"
    return np.bincount(d, minlength=6)[:6].astype(np.int32)


def _words(a: np.ndarray) -> torch.Tensor:
    """uint32 words -> int32 tensor with the same bits (a copy)."""
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


class QuadPool:
    """Device mesh cache: packed quads per chunk slot (int32 words); the
    counts stay on the host (``counts``, ``counts6``), the one source of
    every draw list's counts.  Host bookkeeping as in the reference.
    Where ``written`` is a set (an engine with views sets it), every write
    of a slot's device row adds the slot to it (``take_written``)."""

    # the fused insert+render payload shape (rendering/pipeline.Renderer)
    INSERT_KP = Renderer.INSERT_KP
    INSERT_MC = Renderer.INSERT_MC
    INSERT_FP = Renderer.INSERT_FP

    def __init__(self, slots: int = 4096, qcap: int = QUADS_PER_CHUNK_CAP,
                 *, device="cuda"):
        if slots > 32767:
            raise ValueError("QuadPool slots must be <= 32767 "
                             "(int16 draw-list upload)")
        self.device = resolve_device(device)
        self.slots = slots
        self.qcap = qcap
        self.quads = torch.zeros((slots, qcap), dtype=torch.int32,
                                 device=self.device)
        self.counts = np.zeros(slots, np.int32)
        self.counts6 = np.zeros((slots, 6), np.int32)
        self.positions = np.zeros((slots, 3), np.int32)
        self.by_pos: dict[tuple[int, int, int], int] = {}
        self._free: list[int] = list(range(slots - 1, -1, -1))
        self.overflow_drops = 0
        self._used = np.zeros(slots, bool)
        self._lookup_cache: tuple | None = None
        self._dev_cache: torch.Tensor | None = None  # positions on device
        self.written: set[int] | None = None

    def _wrote(self, slots) -> None:
        if self.written is not None:
            self.written.update(int(s) for s in slots)

    def take_written(self) -> set[int]:
        """The slots whose device rows were written since the last call
        (``written`` must be a set), and ``written`` emptied."""
        got, self.written = self.written, set()
        return got

    def device_tables(self) -> torch.Tensor:
        """The slot positions i32[S, 3] on the pool's device, copied again
        only after a mutation (the counts stay on the host: the gather
        indices are host-built)."""
        if self._dev_cache is None:
            self._dev_cache = torch.from_numpy(self.positions.copy()).to(
                self.device)
        return self._dev_cache

    def __contains__(self, pos) -> bool:
        return tuple(int(c) for c in pos) in self.by_pos

    def slot_of(self, pos) -> int | None:
        return self.by_pos.get(tuple(int(c) for c in pos))

    @classmethod
    def from_numpy(cls, quads, counts6, positions, by_pos, *,
                   device="cuda"):
        """A pool holding the given state: ``quads`` u32[S, Q] rows,
        ``counts6`` i32[S, 6] per-direction counts, ``positions`` i32[S, 3],
        ``by_pos`` {chunk position: slot}.  The free list holds the unused
        slots, lowest first."""
        quads = np.asarray(quads, np.uint32)
        slots, qcap = quads.shape
        pool = cls(slots, qcap, device=device)
        pool.quads = _words(quads).to(pool.device)
        pool.counts6 = np.array(counts6, np.int32)
        pool.counts = pool.counts6.sum(axis=1).astype(np.int32)
        pool.positions = np.array(positions, np.int32)
        pool.by_pos = {tuple(int(c) for c in k): int(s)
                       for k, s in by_pos.items()}
        pool._used[list(pool.by_pos.values())] = True
        pool._free = [s for s in range(slots - 1, -1, -1)
                      if not pool._used[s]]
        return pool

    def _slot_for(self, key) -> int:
        slot = self.by_pos.get(key)
        if slot is None:
            if not self._free:
                raise RuntimeError(
                    "QuadPool exhausted; raise `slots` (mesh cache capacity)")
            slot = self._free.pop()
            self.by_pos[key] = slot
            self._used[slot] = True
        return slot

    def insert(self, pos, quads: np.ndarray | None) -> None:
        key = tuple(int(c) for c in pos)
        slot = self._slot_for(key)
        n = 0
        row = np.zeros(self.qcap, np.uint32)
        if quads is not None:
            n = min(len(quads), self.qcap)
            if len(quads) > self.qcap:
                self.overflow_drops += len(quads) - self.qcap
            row[:n] = quads[:n]
        with prof.ENQUEUE:
            self.quads[slot] = _words(row).to(self.device)
        self._wrote((slot,))
        self.counts[slot] = n
        self.counts6[slot] = _dir_counts(row[:n])
        self.positions[slot] = key
        self._dev_cache = None
        self._lookup_cache = None

    def insert_rows_device(self, positions, quad_rows, counts, c6) -> None:
        """Batched insert of device-resident quad rows (device meshing): the
        host tables take ``counts`` and the per-direction ``c6`` (from the
        meshing call's metadata, not from the rows), then one device
        scatter of the rows i32[k, qcap].  A position may repeat only with
        identical rows (the bucket padding), so the duplicate-index write is
        deterministic."""
        k = len(positions)
        if tuple(quad_rows.shape) != (k, self.qcap):
            raise ValueError(f"quad rows of shape {tuple(quad_rows.shape)} "
                             f"for {k} positions")
        slots = np.zeros(k, np.int64)
        for i, pos in enumerate(positions):
            key = tuple(int(c) for c in pos)
            slot = self._slot_for(key)
            slots[i] = slot
            self.counts[slot] = int(counts[i])
            self.counts6[slot] = c6[i]
            self.positions[slot] = key
        with prof.ENQUEUE:
            self.quads[torch.from_numpy(slots).to(self.device)] = quad_rows
        self._wrote(slots)
        self._dev_cache = None
        self._lookup_cache = None

    def _payload(self, items, kp: int, fp: int | None = None
                 ) -> np.ndarray:
        """Host bookkeeping of ``items`` [(pos, quads-or-None), ...] and
        their u32 payload [slots | starts | counts | flat quads], ``kp``
        entries (padding: copies of entry 0) and ``fp`` flat words (None:
        the total's power of two, at least 2048).  A mesh past ``qcap``
        keeps its first ``qcap`` quads, the rest counted in
        ``overflow_drops``."""
        k = len(items)
        slots = np.zeros(kp, np.int32)
        counts = np.zeros(kp, np.int32)
        parts = []
        for i, (pos, quads) in enumerate(items):
            key = tuple(int(c) for c in pos)
            slot = self._slot_for(key)
            n = 0
            if quads is not None:
                n = min(len(quads), self.qcap)
                if len(quads) > self.qcap:
                    self.overflow_drops += len(quads) - self.qcap
                parts.append(np.asarray(quads[:n], np.uint32))
                self.counts6[slot] = _dir_counts(parts[-1])
            else:
                self.counts6[slot] = 0
            slots[i] = slot
            counts[i] = n
            self.counts[slot] = n
            self.positions[slot] = key
        self._wrote(slots[:k])
        slots[k:] = slots[0]
        counts[k:] = counts[0]
        starts = np.zeros(kp, np.int64)
        starts[:k] = np.cumsum(counts[:k]) - counts[:k]
        total = int(counts[:k].sum())
        if fp is None:
            fp = 1 << max(11, (max(total, 1) - 1).bit_length())
        packed = np.zeros(3 * kp + fp, np.uint32)
        packed[:kp] = slots.astype(np.uint32)
        packed[kp:2 * kp] = starts.astype(np.uint32)
        packed[2 * kp:3 * kp] = counts.astype(np.uint32)
        if total:
            packed[3 * kp:3 * kp + total] = np.concatenate(parts)
        self._dev_cache = None
        self._lookup_cache = None
        return packed

    def insert_many(self, items) -> None:
        """Batched insert of [(pos, quads-or-None), ...] as one flat
        payload and one device scatter (reference ``insert_many``)."""
        if not items:
            return
        if len(items) > 512:
            for i in range(0, len(items), 512):
                self.insert_many(items[i:i + 512])
            return
        if any(it[1] is not None and len(it[1]) > 512 for it in items):
            small = [it for it in items
                     if it[1] is None or len(it[1]) <= 512]
            wide = [it for it in items
                    if it[1] is not None and len(it[1]) > 512]
            if small:
                self.insert_many(small)
            items = wide
        k = len(items)
        kp = 16 if k <= 16 else (64 if k <= 64 else 512)
        packed = self._payload(items, kp)
        mc = 512 if packed[2 * kp:3 * kp].max() <= 512 else self.qcap
        self.dispatch_insert_payload(packed, kp=kp, mc=mc)

    def prepare_insert_payload(self, items, kp: int | None = None,
                               mc: int | None = None,
                               fp: int | None = None) -> np.ndarray | None:
        """Host bookkeeping + ONE u32 payload for the fused insert+render
        frame, or None when the batch does not fit (<= kp entries, meshes
        <= mc quads, flat total <= fp); callers then use insert_many.  The
        host state updates now; the device pool catches up inside the
        frame."""
        kp = self.INSERT_KP if kp is None else kp
        mc = self.INSERT_MC if mc is None else mc
        fp = self.INSERT_FP if fp is None else fp
        items = list(items)
        if not items or len(items) > kp:
            return None
        if any(it[1] is not None and len(it[1]) > mc for it in items):
            return None
        if sum(len(q) for _, q in items if q is not None) > fp:
            return None
        return self._payload(items, kp, fp)

    def dispatch_insert_payload(self, payload: np.ndarray,
                                kp: int | None = None,
                                mc: int | None = None) -> None:
        """Apply a prepared payload with a standalone in-place scatter."""
        with prof.ENQUEUE:
            apply_insert_payload(
                self.quads, _words(payload).to(self.device),
                k=self.INSERT_KP if kp is None else kp,
                mc=self.INSERT_MC if mc is None else mc)

    def remove(self, pos) -> None:
        key = tuple(int(c) for c in pos)
        slot = self.by_pos.pop(key, None)
        if slot is not None:
            self.counts[slot] = 0
            self.counts6[slot] = 0
            self._used[slot] = False
            self._free.append(slot)
            self._dev_cache = None
        self._lookup_cache = None

    def retain(self, predicate) -> list[int]:
        """Drop entries whose position fails the predicate (a dict/set is
        the fast path: direct membership).  Returns the freed slots."""
        if isinstance(predicate, (dict, set, frozenset)):
            keys = [k for k in self.by_pos if k not in predicate]
        else:
            keys = [k for k in self.by_pos if not predicate(k)]
        freed = [self.by_pos[k] for k in keys]
        for key in keys:
            self.remove(key)
        return freed

    @contextlib.contextmanager
    def throwaway_entry(self, pos):
        """A warm-up's throwaway entry: inside the block ``pos`` may be
        inserted, scattered and removed; the block yields the slot it takes
        (the next free one).  Afterwards the entry is gone and that slot's
        device row, the host tables, the free list, the used mask, the
        lookup caches and the overflow count are as before, so later slot
        choices and frames are as without the block."""
        key = tuple(int(c) for c in pos)
        if key in self.by_pos or not self._free:
            raise RuntimeError("a throwaway pool entry needs a free slot and "
                               "no entry at its position")
        slot = self._free[-1]
        saved = (self.quads[slot].clone(),
                 int(self.counts[slot]), self.counts6[slot].copy(),
                 self.positions[slot].copy(), list(self._free),
                 self._lookup_cache, self._dev_cache, self.overflow_drops)
        try:
            yield slot
        finally:
            self.remove(key)
            (row, self.counts[slot], self.counts6[slot],
             self.positions[slot], self._free, self._lookup_cache,
             self._dev_cache, self.overflow_drops) = saved
            self.quads[slot] = row
            self._wrote((slot,))

    @staticmethod
    def _pack_keys(pos: np.ndarray) -> np.ndarray:
        p = np.asarray(pos, np.int64)
        b = np.int64(1 << 20)
        return (((p[:, 0] + b) << 42) | ((p[:, 1] + b) << 21)
                | (p[:, 2] + b))

    def lookup_table(self):
        """(keys i64[U], slots i32[U]): the used slots' positions packed
        21 bits an axis (``_pack_keys``), sorted, and their slots; built
        again after a mutation, which drops it."""
        if self._lookup_cache is None:
            used = np.nonzero(self._used)[0].astype(np.int32)
            keys = self._pack_keys(self.positions[used])
            o = np.argsort(keys)
            self._lookup_cache = (keys[o], used[o])
        return self._lookup_cache

    def lookup_slots(self, pos: np.ndarray):
        """Vectorized pos -> slot join: (slots i32[N], has bool[N])."""
        pk, ps = self.lookup_table()
        q = self._pack_keys(pos)
        if len(pk) == 0 or len(q) == 0:
            return (np.zeros(len(q), np.int32), np.zeros(len(q), bool))
        ii = np.minimum(np.searchsorted(pk, q), len(pk) - 1)
        hit = pk[ii] == q
        return ps[ii].astype(np.int32), hit


@dataclass
class FrameResult:
    color: torch.Tensor  # int32[H, W] ARGB bits, on the engine's device
    depth: torch.Tensor  # f32[H, W]
    stats: torch.Tensor  # i32[6]: gathered, rasterized, overflow,
    #                      bin_overflow, subpixel_culled, hiz_culled
    rendered_meshes: int
    visible_chunks: int

    def color_numpy(self) -> np.ndarray:
        return np.array(self.color.cpu()).view(np.uint32)

    def depth_numpy(self) -> np.ndarray:
        return np.array(self.depth.cpu())


@dataclass
class DrawList:
    """A funnel's draw list (``Engine.draw_list``): the visible meshed
    chunks front to back, padded to the renderer's ``visible_chunks_cap``
    (the first ``n`` rows hold chunks)."""

    slots: np.ndarray      # i32[vcap] pool slots
    counts6: np.ndarray    # i32[vcap, 6] quads by face direction
    dir_mask: np.ndarray   # i32[vcap, 6] face directions kept
    positions: np.ndarray  # i32[vcap, 3] chunk positions
    n: int


@dataclass
class ViewsResult:
    """``Engine.render_views``' views, on the engine's device."""

    color: torch.Tensor    # int32[B, H, W] ARGB bits
    depth: torch.Tensor    # f32[B, H, W]
    stats: torch.Tensor    # i32[B, 6]: gathered, the bands' reduced count
    #                        (psum // tp), overflow and bin_overflow summed
    #                        over the bands, subpixel_culled, hiz_culled
    reduced: torch.Tensor  # i32[B, tp]: the reduced count on each tp card


class Engine:
    """Owns world + camera + mesh pool + renderer; drives frames."""

    def __init__(self, render_config: RenderConfig | None = None,
                 world_config: WorldConfig | None = None,
                 pool_slots: int = 4096,
                 horizon_config: HorizonCullingConfig | None = None,
                 device_meshing: bool = False,
                 resident_stream: bool | None = None, *, device="cuda",
                 mesh_cards: int | None = None):
        # mesh remesh batches of 4 chunks or more on the device
        # (ops/meshing_device.py, byte-identical to the host mesher)
        self.device_meshing = device_meshing
        self.device = resolve_device(device)
        self.config = render_config or RenderConfig()
        # resident superset stream mode (DPVR_RESIDENT=1): the stream holds
        # every pooled mesh within view distance of the camera's chunk cell
        # (the world's own sphere test at the cell) with a direction mask
        # widened over the cell, so it stays valid for any rotation and any
        # position in the cell; the device's exact culls drop the extra
        # quads and frames equal the serial path's.  It rebuilds on cell
        # crossings, unloads and invalidate_resident(); newly streamed
        # chunks append one frame late.  Costs: twice the gather cap (the
        # compaction runs), sphere-sized draw lists, and item headroom
        self.resident_stream = (
            bool(int(os.environ.get("DPVR_RESIDENT", "0") or "0"))
            if resident_stream is None else resident_stream)
        if self.resident_stream:
            self.config = dc_replace(
                self.config, gather_cap=2 * self.config.gather_cap,
                visible_chunks_cap=max(self.config.visible_chunks_cap, 1024),
                tile_k_cap=max(self.config.tile_k_cap, 131072))
        self._res_uploads = None      # (quads, quad_world) of the stream
        self._res_total = 0           # its length, tracked on the host
        self._res_cell = None         # the camera's chunk cell at build
        self._res_pos: set = set()    # chunk positions in the stream
        self._res_n = 0               # chunks in the stream
        self._res_dirty = False       # rebuild on the next frame
        self._res_appends = 0         # frames that took the append rider
        self._res_pending = None      # batch appended by the next frame
        self._res_insert = None       # its scatter payload, same frame
        self._res_fused_inserts = 0   # frames that took the fused scatter
        # chunks meshed a resident frame, nearest first (the rest carry
        # over), sized to the resident insert payload
        self.resident_mesh_budget = _resident_budget()
        self._stale_set: set = set()  # the resident stash's members
        self.world = World(world_config or WorldConfig(
            view_distance=12, frustum_culling=True, max_chunks_per_frame=16))
        if self.resident_stream:
            self.world.track_added = True
        self.renderer = Renderer(self.config, device=self.device)
        self.pool = QuadPool(slots=pool_slots, device=self.device)
        aspect = self.config.width / self.config.height
        self.camera = Camera(np.array([0.0, 10.0, 20.0], np.float32), aspect)
        self.controller = CameraController()
        self.horizon_config = horizon_config or HorizonCullingConfig()
        self.enable_horizon_culling = True
        self.enable_occlusion_culling = False
        self.occlusion_epsilon = 0.005
        self.log_fps = False
        self.slow_frame_ms = 16.0
        self._fps_done = prof.TRACER.completed
        self._fps_t0 = time.perf_counter()
        self._neighbor_offsets = [
            (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)
        ]
        self._seen_world_version = -1
        self._seen_unload_version = -1
        self._seen_vp = None
        self._visible_cache = None
        # the native funnel's slot of each world table row (world version,
        # pool lookup table, i32[n]; -2 where not yet found)
        self._join = None
        self._upload_cache = None
        # temporal_hiz: the last static frame's max pyramid and its
        # (draw-list signature, view-projection bytes) identity
        self._prev_hiz = None
        self._prev_hiz_sig = None
        # streaming fast path: fold small remesh batches into the frame
        # (QuadPool.prepare_insert_payload + render_fused_insert)
        self.fused_insert = True
        self._pending_insert: np.ndarray | None = None
        # (rendered meshes, visible chunks) of each entered but not yet
        # emitted frame (render_frame_pipelined)
        self._pipe_meta: collections.deque = collections.deque()
        # one-frame-stale pool mode: a frame's remesh batch is meshed and
        # inserted after its render call, so a newly streamed chunk shows
        # one frame later than in the serial mode and a remeshed neighbour
        # keeps its previous mesh for that frame; nothing else differs
        self.stale_streaming = (
            bool(int(os.environ.get("DPVR_STALE_POOL", "0") or "0"))
            or self.resident_stream)  # resident appends land one frame late
        self._stale_stash: list = []
        # render_views: the (dp, tp) mesh of ``mesh_cards`` devices (the
        # first CUDA cards, card 0 the engine's; on the CPU the engine's
        # device listed that many times) and its render, made at first use
        self.mesh = None
        if mesh_cards:
            self.mesh = make_mesh(mesh_cards, devices=(
                None if self.device.type == "cuda"
                else [self.device] * mesh_cards))
            if self.mesh.devices[0, 0] != torch.empty(
                    0, device=self.device).device:
                raise ValueError(f"the mesh {self.mesh} does not start at "
                                 f"the engine's device {self.device}")
        self._views: ViewsRender | None = None
        self._hold_world = False  # a view after the first: no world update

    # ------------------------------------------------------------- meshing
    def _remesh(self, visible_chunks) -> int:
        """Incremental remeshing with neighbor invalidation."""
        to_mesh: list[tuple[int, int, int]] = []
        meshed = self.pool.by_pos
        loaded = self.world.chunks
        for chunk in visible_chunks:
            pos = chunk.position_key
            if pos not in meshed:
                to_mesh.append(pos)
                for off in self._neighbor_offsets:
                    np_ = (pos[0] + off[0], pos[1] + off[1], pos[2] + off[2])
                    if np_ in loaded and np_ in meshed:
                        to_mesh.append(np_)
        return self._mesh_list(to_mesh)

    def _missing_remesh_list(self, vis_pos: np.ndarray) -> list:
        """Visible-but-unmeshed chunks plus their loaded, meshed
        neighbors (whose border faces change)."""
        _, has = self.pool.lookup_slots(vis_pos)
        if has.all():
            return []
        return self._remesh_list_of(np.asarray(vis_pos[~has], np.int64))

    def _remesh_list_of(self, missing: np.ndarray) -> list:
        """The chunks ``missing`` i64[M, 3] (visible, no pool slot) plus
        their loaded, meshed neighbors."""
        if not len(missing):
            return []
        offs = np.asarray(self._neighbor_offsets, np.int64)
        nbrs = (missing[:, None, :] + offs[None, :, :]).reshape(-1, 3)
        _, nb_meshed = self.pool.lookup_slots(nbrs)
        keep = nbrs[nb_meshed]
        loaded = self.world.chunks
        to_mesh = [tuple(p) for p in missing.tolist()]
        to_mesh += [pos for p in keep.tolist()
                    if (pos := (p[0], p[1], p[2])) in loaded]
        return to_mesh

    def _remesh_positions(self, vis_pos: np.ndarray) -> int:
        return self._mesh_list(self._missing_remesh_list(vis_pos),
                               defer=True)

    def _mesh_list(self, to_mesh, defer: bool = False) -> int:
        if not to_mesh:
            return 0
        with prof.MESHING:
            to_mesh = sorted(set(to_mesh))
            if self.device_meshing and len(to_mesh) >= 4:
                return self._remesh_device(to_mesh)
            batch = []
            for pos in to_mesh:
                chunk = self.world.chunks.get(pos)
                if chunk is None:
                    continue
                batch.append((pos, mesh_chunk(chunk, self.world.chunks)))
            prof.CHUNKS_MESHED.add(len(batch))
            if defer and self.fused_insert and self._pending_insert is None:
                # fold the insert into this frame's render call
                payload = self.pool.prepare_insert_payload(batch)
                if payload is not None:
                    self._pending_insert = payload
                    return len(to_mesh)
            self.pool.insert_many(batch)
            return len(to_mesh)

    def _mesh_list_resident(self, to_mesh) -> None:
        """Resident streaming tail: mesh the batch and queue its pool
        scatter as a payload riding the next frame's step
        (``render_prepared_append_insert``), the frame where the batch
        first renders.  The host pool tables update now, so this frame's
        append metadata sees the new meshes.  Meshes over the payload's
        per-mesh cap, and batches that do not fit its shape, scatter now
        (``insert_many``).  A device-meshed batch lands in the pool at once
        and queues nothing, as the reference's does."""
        with prof.MESHING:
            if self.device_meshing and len(to_mesh) >= 4:
                self._remesh_device(sorted(set(to_mesh)))
                return
            batch = []
            for pos in sorted(set(to_mesh)):
                chunk = self.world.chunks.get(pos)
                if chunk is None:
                    continue
                batch.append((pos, mesh_chunk(chunk, self.world.chunks)))
            prof.CHUNKS_MESHED.add(len(batch))
            if not batch:
                return
            big = [(p, q) for p, q in batch
                   if q is not None and len(q) > RESIDENT_INSERT_MC]
            if big:
                self.pool.insert_many(big)
                bigset = {p for p, _ in big}
                batch = [(p, q) for p, q in batch if p not in bigset]
            if batch and self._res_insert is None:
                payload = self.pool.prepare_insert_payload(
                    batch, kp=RESIDENT_INSERT_KP, mc=RESIDENT_INSERT_MC,
                    fp=RESIDENT_INSERT_FP)
                if payload is not None:
                    self._res_insert = payload
                    return
            if batch:
                self.pool.insert_many(batch)

    def _flush_res_insert(self) -> None:
        """Scatter a queued resident payload on its own, before anything
        outside the fused step reads the device pool (rebuilds, frames
        without an append)."""
        if self._res_insert is not None:
            self.pool.dispatch_insert_payload(
                self._res_insert, kp=RESIDENT_INSERT_KP,
                mc=RESIDENT_INSERT_MC)
            self._res_insert = None

    def _remesh_device(self, to_mesh) -> int:
        """Batched meshing on the device (ops/meshing_device.py): voxels and
        the neighbours' border planes go up once, and the packed rows land
        in the pool there.  Uniform chunks mesh to None, as on the host.
        Batches of at most 512 chunks, padded to their bucket by repeating
        the first chunk, whose slot the padding rows rewrite with its own
        row; planes past the merge's steps add to ``overflow_drops``."""
        from ..ops import meshing_device as MD

        varied, uniform = [], []
        for pos in to_mesh:
            chunk = self.world.chunks.get(pos)
            if chunk is None:
                continue
            (uniform if chunk.is_uniform else varied).append((pos, chunk))
        prof.CHUNKS_MESHED.add(len(varied) + len(uniform))
        self.pool.insert_many([(pos, None) for pos, _ in uniform])
        if not varied:
            return len(to_mesh)
        positions = [pos for pos, _ in varied]
        dense_cache: dict[tuple, np.ndarray | None] = {}

        def dense_at(p):
            if p not in dense_cache:
                c = self.world.chunks.get(p)
                dense_cache[p] = None if c is None else c.dense()
            return dense_cache[p]

        blocks_by_pos = {}
        for pos, _ in varied:
            blocks_by_pos[pos] = dense_at(pos)
            for off in self._neighbor_offsets:
                np_ = (pos[0] + off[0], pos[1] + off[1], pos[2] + off[2])
                d = dense_at(np_)
                if d is not None:
                    blocks_by_pos[np_] = d
        for i in range(0, len(varied), 512):
            part = positions[i:i + 512]
            planes = MD.neighbor_planes_from_batch(blocks_by_pos, part)
            batch = np.stack([blocks_by_pos[p] for p in part])
            with prof.ENQUEUE:
                quads, counts, overflow, c6, bucket = (
                    MD.mesh_chunks_device_bucketed(batch, planes,
                                                   qcap=self.pool.qcap,
                                                   device=self.device))
            if bucket != len(part):
                pad = bucket - len(part)
                part = part + [part[0]] * pad
                counts = np.concatenate([counts, counts[:1].repeat(pad)])
                c6 = np.concatenate([c6, c6[:1].repeat(pad, axis=0)])
            self.pool.insert_rows_device(part, quads, counts, c6)
            self.pool.overflow_drops += int(overflow.sum())
        return len(to_mesh)

    # ------------------------------------------------------- runtime toggles
    def toggle_shading(self) -> bool:
        """The reference's F key: the renderer rebuilds its colour tables
        (``Renderer.set_shading``, on the config the engine shares)."""
        self.renderer.set_shading(not self.config.enable_shading)
        return self.config.enable_shading

    def toggle_occlusion_culling(self) -> bool:
        """The reference's O key."""
        self.enable_occlusion_culling = not self.enable_occlusion_culling
        return self.enable_occlusion_culling

    def set_view_distance(self, vd: int) -> None:
        """The reference's 1/2/3 keys."""
        self.world.set_view_distance(vd)

    def prime(self) -> None:
        """Generate + mesh everything currently visible."""
        frustum = self.camera.extract_frustum()
        visible = self.world.get_visible_chunks_frustum(
            self.camera.position, frustum)
        self._remesh(visible)

    def prime_all(self) -> None:
        """Mesh every loaded chunk (the warm-cache steady state: a moving
        camera then hits the mesh cache)."""
        self._remesh(list(self.world.chunks.values()))

    def warm_buckets(self, pipelined: bool = False) -> None:
        """Build the kernels and capture every capacity bucket's graphs
        (``Renderer.warm_buckets``), as the reference pre-traces its jit
        programs, so that a camera whose quad total crosses into another
        bucket replays a graph at once.  ``pipelined`` adds the
        frames-in-flight steps' graphs.  The pool, the caches and every
        later frame are as without the call."""
        self.renderer.warm_buckets(self.pool.quads, pipelined=pipelined)

    def warm_streaming(self) -> None:
        """Run the streaming path's device calls once ahead of the frame
        loop, on a throwaway pool entry: the batched scatter at each batch
        size and width of ``QuadPool.insert_many``'s ladder, then (with
        ``fused_insert``) one fused insert+render frame of the current
        draw list's capacity bucket and its neighbours (every bucket before
        a first frame).  The reference compiles these shapes here; the
        port captures the fused frame's graph of each of those buckets
        (the scatter ladder runs eagerly).  Afterwards the throwaway
        slot's device row, its host tables, the free list, the used mask
        and the lookup caches are restored exactly, so later slot choices,
        the upload cache and every later frame are as without the call
        (``QuadPool.throwaway_entry``)."""
        with self.pool.throwaway_entry(_THROWAWAY) as slot:
            self._warm_scatter_ladder()
            if self.fused_insert:
                self._warm_fused_insert(slot)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm_resident(self) -> None:
        """Run the resident mode's device calls once ahead of the frame
        loop, which in this mode replaces warm_buckets and warm_streaming:
        the scatter ladder (on a throwaway entry), the stream's rebuild at
        the camera's cell and its step, the append rider (a zero-count
        batch: nothing blends), the fused scatter + append step and the
        standalone resident-shape scatter (the throwaway entry again).  The
        reference compiles these programs here; the port captures the
        stream's static step (``Renderer.render_prepared``) and runs the
        rest eagerly.  The stream stays as built, and the pool is left as
        without the call (``QuadPool.throwaway_entry``): slots, rows,
        counts, free list and lookup caches."""
        if not self.resident_stream:
            raise RuntimeError("warm_resident needs resident_stream")
        if self.device.type == "cuda":
            from .. import _build

            _build.lib()
        with self.pool.throwaway_entry(_THROWAWAY):
            self._warm_scatter_ladder()
        cell = world_to_chunk_pos(self.camera.position)
        if self._rebuild_resident(cell):
            vp = self.camera.view_projection_matrix()
            uploads = (*self._res_uploads, np.int32(self._res_total))
            self.renderer.render_prepared(uploads, vp, self.camera.position)
            zmeta = pack_append_meta(np.zeros(1, np.int32),
                                     np.zeros((1, 6), np.int32),
                                     np.zeros((1, 3), np.int32))
            self.renderer.render_prepared_append(
                uploads, vp, self.camera.position, self.pool.quads, zmeta, 0)
            with self.pool.throwaway_entry(_THROWAWAY):
                item = [(_THROWAWAY, np.zeros(4, np.uint32))]
                payload = self.pool.prepare_insert_payload(
                    item, kp=RESIDENT_INSERT_KP, mc=RESIDENT_INSERT_MC,
                    fp=RESIDENT_INSERT_FP)
                self.renderer.render_prepared_append_insert(
                    uploads, vp, self.camera.position, self.pool.quads,
                    zmeta, 0, payload)
                self.pool.dispatch_insert_payload(
                    self.pool.prepare_insert_payload(
                        item, kp=RESIDENT_INSERT_KP, mc=RESIDENT_INSERT_MC,
                        fp=RESIDENT_INSERT_FP),
                    kp=RESIDENT_INSERT_KP, mc=RESIDENT_INSERT_MC)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _warm_scatter_ladder(self) -> None:
        """The batched scatter at each batch size and width of
        ``QuadPool.insert_many``'s ladder, on the throwaway entry."""
        for bs, width in ((1, 450), (5, 450), (10, 450), (17, 1), (17, 200),
                          (17, 450), (30, 450), (64, 450), (1, 513),
                          (4, 513)):
            self.pool.insert_many([(_THROWAWAY, np.zeros(width, np.uint32))]
                                  * bs)

    def _warm_fused_insert(self, slot: int) -> None:
        """One fused insert+render frame a bucket (the current draw list's
        and its neighbours, or all before a first frame)
        (``Renderer.warm_fused_insert``): the draw list is the throwaway
        entry at ``slot`` alone, its payload that entry's mesh."""
        pool = self.pool
        payload = pool.prepare_insert_payload(
            [(_THROWAWAY, np.zeros(4, np.uint32))])
        assert payload is not None and pool.by_pos[_THROWAWAY] == slot
        buckets = list(self.renderer.gather_buckets)
        if self._upload_cache is not None:
            total = int((self._last_counts_sel * self._last_dir_mask).sum())
            cur = self.renderer.bucket_for(total)
            i = buckets.index(cur) if cur in buckets else 0
            buckets = buckets[max(0, i - 1):i + 2]
        self.renderer.warm_fused_insert(pool.quads, slot, pool.counts6[slot],
                                        payload, buckets)

    def _dir_keep_mask(self, positions, cam_pos) -> np.ndarray:
        """Per-chunk face-direction keep mask [n, 6]: 0 where every quad of
        the direction is provably backfacing (a strict subset of the
        device backface cull, exact in f32).  All ones when the device
        cull is off or in span mode, whose clip-normal test differs."""
        if not self.config.backface_culling or self.config.span_mode:
            return np.ones((len(positions), 6), np.int32)
        m = positions.astype(np.float32) * np.float32(CHUNK_SIZE)
        cam = np.asarray(cam_pos, np.float32)
        keep = np.empty((len(positions), 6), np.int32)
        for axis in range(3):
            keep[:, 2 * axis] = cam[axis] > m[:, axis] + np.float32(1.0)
            keep[:, 2 * axis + 1] = cam[axis] < m[:, axis] + np.float32(31.0)
        return keep

    # --------------------------------------------------------------- frame
    def _funnel(self, dt: float):
        """Host side of a frame: camera/world update, visibility,
        remeshing, culling funnel, draw-list build.  Fills the _last_*
        draw-list arrays, new ones every call, and returns (vp, sig, n,
        n_visible, cam_same).  The draw list comes from the native pass
        (``_funnel_native``) where the native library is built and the
        occlusion pass is off, else from its numpy twin
        (``_funnel_numpy``); the two give the same arrays bit for bit."""
        with prof.FUNNEL:
            cam = self.camera
            self.controller.update_camera(cam, dt)
            if not self._hold_world:
                self.world.update(cam.position)
            if (self.enable_occlusion_culling
                    or native_bridge.funnel_pass is None):
                n_visible_meshes, cam_same = self._funnel_numpy()
            else:
                n_visible_meshes, cam_same = self._funnel_native()
            n = self._last_n_visible
            sig = (self.world.version,
                   self._last_visible_slots[:n].tobytes(),
                   self._last_counts_sel[:n].tobytes(),
                   self._last_dir_mask[:n].tobytes())
            return (cam.view_projection_matrix(), sig, n, n_visible_meshes,
                    cam_same)

    def _view_state(self):
        """(view-projection, cam_same, cached): whether the camera's matrix
        is the last visibility query's, and whether that query's result
        still holds (the same matrix and world)."""
        vp_now = self.camera.view_projection_matrix()
        cam_same = (self._seen_vp is not None
                    and np.array_equal(self._seen_vp, vp_now))
        cached = (cam_same and self.world.version == self._seen_world_version
                  and self._visible_cache is not None)
        return vp_now, cam_same, cached

    def _pool_follows(self, remesh: list) -> None:
        """After a new camera or world: mesh ``remesh`` (the visible chunks
        with no mesh and their meshed neighbours) into the pool, or in
        stale-pool mode stash it for after the render call, where this
        frame's draw list comes from the pool as it is
        (_apply_stale_stash); after an unload the pool keeps only loaded
        chunks."""
        if self.stale_streaming:
            self._stale_stash += remesh
        else:
            self._mesh_list(remesh, defer=True)
        if self.world.unload_version != self._seen_unload_version:
            self.pool.retain(self.world.chunks)
            self._seen_unload_version = self.world.unload_version

    def _funnel_numpy(self):
        """The funnel's visibility and draw-list stage in numpy, the native
        pass's twin: fills the _last_* arrays and returns (n_visible,
        cam_same)."""
        cam = self.camera
        vp_now, cam_same, cached = self._view_state()
        if cached:
            vis_pos = self._visible_cache
        else:
            world_v = self.world.version
            frustum = cam.extract_frustum()
            vis_pos = self.world.get_visible_positions(cam.position,
                                                       frustum)
            self._visible_cache = vis_pos
            if not (cam_same and world_v == self._seen_world_version):
                self._pool_follows(self._missing_remesh_list(vis_pos))
            self._seen_vp = vp_now.copy()
            self._seen_world_version = self.world.version

        slots_all, has = self.pool.lookup_slots(vis_pos)
        hs = slots_all[has]
        nz = self.pool.counts[hs] > 0
        slots = hs[nz]
        centers = (vis_pos[has][nz].astype(np.float32) * CHUNK_SIZE
                   + 16.0 if len(slots)
                   else np.zeros((0, 3), np.float32))
        n_visible_meshes = len(slots)
        vp = cam.view_projection_matrix()

        if n_visible_meshes:
            order = sort_front_to_back(centers, cam.position)
            slots = slots[order]
            centers = centers[order]
            if self.enable_horizon_culling:
                keep = horizon_cull_mask(centers, cam.position,
                                         self.horizon_config)
                slots, centers = slots[keep], centers[keep]
            if self.enable_occlusion_culling and len(slots):
                rects, near, _ = project_chunk_rects(
                    centers, vp, self.config.width, self.config.height)
                d2 = ((centers - cam.position[None, :]) ** 2).sum(-1)
                use_occ = d2 >= (CHUNK_SIZE * 2.0) ** 2
                keep = occlusion_pass(
                    rects, near, use_occ, self.config.width,
                    self.config.height, epsilon=self.occlusion_epsilon)
                slots, centers = slots[keep], centers[keep]

        vcap = self.config.visible_chunks_cap
        visible_slots = np.zeros(vcap, np.int32)
        counts_sel = np.zeros((vcap, 6), np.int32)
        mask_sel = np.ones((vcap, 6), np.int32)
        positions_sel = np.zeros((vcap, 3), np.int32)
        n = min(len(slots), vcap)
        if n:
            visible_slots[:n] = slots[:n]
            counts_sel[:n] = self.pool.counts6[slots[:n]]
            positions_sel[:n] = self.pool.positions[slots[:n]]
            mask_sel[:n] = self._dir_keep_mask(positions_sel[:n],
                                               cam.position)
        self._last_visible_slots = visible_slots
        self._last_counts_sel = counts_sel
        self._last_dir_mask = mask_sel
        self._last_positions_sel = positions_sel
        self._last_n_visible = n
        return n_visible_meshes, cam_same

    def _funnel_native(self):
        """The funnel's visibility and draw-list stage as one native pass
        (``native_bridge.funnel_pass``) over the world's chunk table, or
        over the cached visible chunks while camera and world stand still:
        fills the _last_* arrays and returns (n_visible, cam_same).  The
        frustum test takes numpy's product of the chunks' corners with the
        plane normals, as ``Frustum.inside_mins`` does.  A frame that
        meshes or unloads runs the pass again over its visible chunks,
        once the pool has changed.  Counts ``funnel_native``."""
        prof.FUNNEL_NATIVE.add(1)
        cam = self.camera
        vp_now, cam_same, cached = self._view_state()
        if cached:
            out = self._draw_pass(self._visible_cache)
        else:
            world_v = self.world.version
            table, mins = self.world.visibility_table()
            dots = off = None
            if self.world.config.frustum_culling:
                n_t, off = cam.extract_frustum().plane_terms(
                    float(CHUNK_SIZE))
                dots = mins @ n_t
            lookup = self.pool.lookup_table()
            join = self._join
            if join is None or join[0] != world_v or join[1] is not lookup:
                # each table row's slot, found as the rows turn visible
                join = self._join = (world_v, lookup,
                                     np.full(len(table), -2, np.int32))
            out = self._draw_pass(table, dots, off,
                                  self.world.config.view_distance ** 2,
                                  join[2])
            self._visible_cache = out[0]
            if not (cam_same and world_v == self._seen_world_version):
                self._pool_follows(self._remesh_list_of(out[1]))
                if self.pool.lookup_table() is not lookup:
                    out = self._draw_pass(out[0])
            self._seen_vp = vp_now.copy()
            self._seen_world_version = self.world.version
        (_, _, n_visible_meshes, n, self._last_visible_slots,
         self._last_counts_sel, self._last_dir_mask,
         self._last_positions_sel) = out
        self._last_n_visible = n
        return n_visible_meshes, cam_same

    def _draw_pass(self, table, dots=None, off=None, vd2: int = -1,
                   join=None):
        """``native_bridge.funnel_pass`` over the chunks ``table`` on the
        pool as it is, with the engine's switches (the frustum and sphere
        tests, and the rows' slots, only where given)."""
        cfg, pool = self.config, self.pool
        return native_bridge.funnel_pass(
            table, dots, off, vd2, pool.lookup_table(), join, pool.counts,
            pool.counts6, pool.positions,
            np.asarray(self.camera.position, np.float32),
            self.horizon_config if self.enable_horizon_culling else None,
            cfg.backface_culling and not cfg.span_mode,
            cfg.visible_chunks_cap)

    def _apply_stale_stash(self) -> None:
        """Stale-pool mode: mesh and insert the batch this frame's funnel
        collected, after the frame's render call went out (the host
        meshing overlaps the device render).  The batch takes the
        standalone scatter, never the fused insert: the frame that would
        carry it has been issued."""
        if self._stale_stash:
            stash, self._stale_stash = self._stale_stash, []
            self._mesh_list(stash, defer=False)

    # ----------------------------------------- resident superset stream
    def invalidate_resident(self) -> None:
        """Rebuild the resident stream on the next frame.  Call after a
        pool or world change made outside the engine (block edits, manual
        remeshes); the engine's own streaming and unloads do it
        themselves."""
        self._res_dirty = True

    def _rebuild_resident(self, cell) -> bool:
        """Build the resident stream: every pooled mesh within the world's
        sphere test of ``cell`` (so the frustum draw list of any camera in
        the cell is a subset), the direction mask widened to the union of
        the exact masks over the cell (exact f32 integer arithmetic).
        Returns False when the chunks exceed the draw-list cap or the quads
        the largest bucket; the caller then falls back to the frustum
        path."""
        pool = self.pool
        live = np.flatnonzero(pool.counts > 0)
        vcap = self.config.visible_chunks_cap
        if len(live) == 0:
            return False
        p = pool.positions[live].astype(np.float32)
        d = p - np.float32(np.asarray(cell, np.float32))
        keep = np.einsum("ij,ij->i", d, d) <= np.float32(
            self.world.config.view_distance ** 2)
        sl = live[keep]
        n = len(sl)
        if n == 0 or n > vcap:
            return False
        vs = np.zeros(vcap, np.int32)
        cs = np.zeros((vcap, 6), np.int32)
        ps = np.zeros((vcap, 3), np.int32)
        vs[:n] = sl
        cs[:n] = pool.counts6[sl]
        ps[:n] = pool.positions[sl]
        mk = np.ones((vcap, 6), np.int32)
        m = ps[:n].astype(np.float32) * np.float32(CHUNK_SIZE)
        lo = np.asarray(cell, np.float32) * np.float32(CHUNK_SIZE)
        hi = lo + np.float32(CHUNK_SIZE)
        for axis in range(3):
            # any camera below hi passes the widened +axis test, any above
            # lo the widened -axis test (_dir_keep_mask's tests)
            mk[:n, 2 * axis] = hi[axis] > m[:, axis] + np.float32(1.0)
            mk[:n, 2 * axis + 1] = lo[axis] < m[:, axis] + np.float32(31.0)
        total = int((pool.counts6[sl] * mk[:n]).sum())
        if total > self.renderer.gather_buckets[-1]:
            return False
        q, w, _t = self.renderer.prepare_uploads(
            pool.quads, vs, cs, ps, dir_mask=mk)
        self._res_uploads = (q, w)
        self._res_total = total
        self._res_cell = tuple(int(c) for c in cell)
        self._res_pos = {tuple(int(x) for x in row)
                         for row in pool.positions[sl]}
        self._res_n = n
        self._res_dirty = False
        # a queued batch is in the pool already, so the new stream holds it
        self._res_pending = None
        return True

    def _queue_append(self, new_positions) -> None:
        """Queue newly inserted meshes for the next frame's step (the
        append rider, every direction kept: a superset, exact).  Batches
        over the rider's caps, or a stream with no room left, flag a
        rebuild instead."""
        pool = self.pool
        cell = np.asarray(self._res_cell, np.float32)
        vd2 = np.float32(self.world.config.view_distance ** 2)
        slots = []
        for pos in new_positions:
            s = pool.by_pos.get(pos)
            if s is None:
                continue
            d = np.asarray(pos, np.float32) - cell
            if float((d * d).sum()) > vd2:
                continue  # outside the build sphere: the next rebuild's
            self._res_pos.add(pos)
            if pool.counts[s] > 0:
                slots.append(s)
        if not slots:
            return
        slots = np.asarray(slots, np.int32)
        c6 = pool.counts6[slots]
        batch = int(c6.sum())
        stream_len = int(self._res_uploads[0].shape[0])
        cap = resident_append_cap(stream_len)
        if (len(slots) > RESIDENT_APPEND_VCAP or batch > cap
                or self._res_total + cap > stream_len):
            self._res_dirty = True
            return
        ameta = pack_append_meta(slots, c6, pool.positions[slots])
        self._res_pending = (ameta, self._res_total, batch, len(slots))
        self._res_total += batch  # the stream copy lands next frame
        self._res_n += len(slots)

    def _render_frame_resident(self, dt: float) -> FrameResult | None:
        """A resident frame: no frustum draw list and no expansion, one
        step on the resident stream (with the previous frame's batch
        appended, and scattered, when one is queued), then the frame's
        meshing and the append queued for the next frame.  Returns None
        when the scene exceeds the resident caps."""
        with prof.FUNNEL:
            if not self._resident_funnel(dt):
                return None
        cam = self.camera
        vp = cam.view_projection_matrix()
        uploads = (*self._res_uploads, np.int32(self._res_total))
        with prof.DISPATCH:
            color, depth, stats = self._resident_dispatch(uploads, vp)
        if self._stale_stash:
            # nearest first (they turn visible soonest); the rest carry
            # over under the budget
            if len(self._stale_stash) > self.resident_mesh_budget:
                c = cam.position / np.float32(CHUNK_SIZE)
                arr = np.asarray(self._stale_stash, np.float32)
                d2 = ((arr - c[None, :]) ** 2).sum(1)
                order = np.argsort(d2, kind="stable")
                self._stale_stash = [self._stale_stash[i] for i in order]
            batch = self._stale_stash[:self.resident_mesh_budget]
            self._stale_stash = self._stale_stash[self.resident_mesh_budget:]
            self._stale_set.difference_update(batch)
            self._mesh_list_resident(batch)
            newpos = [pos for pos in batch if pos not in self._res_pos]
            if newpos:
                self._queue_append(newpos)
        return FrameResult(color, depth, stats, self._res_n, self._res_n)

    def _resident_funnel(self, dt: float) -> bool:
        """The resident frame's host side: camera and world update, the
        streamed chunks queued for meshing, unloads, and the stream's
        rebuild when the camera's cell or the pool changed.  False when
        the scene exceeds the resident caps."""
        cam = self.camera
        self.controller.update_camera(cam, dt)
        self.world.update(cam.position)
        if self.world.version != self._seen_world_version:
            # the chunks streamed in since the last frame (the world's add
            # log) and their meshed neighbours
            added = self.world.drain_added()
            if added:
                for p in self._missing_remesh_list(
                        np.asarray(added, np.int64)):
                    if p not in self._stale_set:
                        self._stale_set.add(p)
                        self._stale_stash.append(p)
            self._seen_world_version = self.world.version
        if self.world.unload_version != self._seen_unload_version:
            self.pool.retain(self.world.chunks)
            self._seen_unload_version = self.world.unload_version
            self._res_dirty = True
        cell = world_to_chunk_pos(cam.position)
        if (self._res_uploads is None or self._res_dirty
                or cell != self._res_cell):
            # the rebuild expands from the device pool: a queued payload
            # lands first
            self._flush_res_insert()
            # the full sphere scan meshes stragglers the add log missed
            vis = self.world.get_visible_positions(cam.position, None)
            for p in self._missing_remesh_list(vis):
                if p not in self._stale_set:
                    self._stale_set.add(p)
                    self._stale_stash.append(p)
            with prof.ENQUEUE:
                if not self._rebuild_resident(cell):
                    return False
        return True

    def _resident_dispatch(self, uploads, vp):
        """The resident frame's step: (color, depth, stats)."""
        cam = self.camera
        if self._res_pending is None:
            # a remesh-only batch still scatters before the stream's pool
            # rows are read again
            self._flush_res_insert()
            return self.renderer.render_prepared(uploads, vp, cam.position)
        # the previous frame's batch rides this step: pool scatter (when
        # its payload fit the resident shape), append, render
        ameta, offset, _batch, _nc = self._res_pending
        self._res_pending = None
        if self._res_insert is not None:
            payload = self._res_insert
            self._res_insert = None
            color, depth, stats, new_up = (
                self.renderer.render_prepared_append_insert(
                    uploads, vp, cam.position, self.pool.quads, ameta,
                    offset, payload))
            self._res_fused_inserts += 1
        else:
            color, depth, stats, new_up = (
                self.renderer.render_prepared_append(
                    uploads, vp, cam.position, self.pool.quads, ameta,
                    offset))
        self._res_uploads = new_up
        self._res_appends += 1
        return color, depth, stats

    def render_frame(self, dt: float = 0.016) -> FrameResult:
        """One serial frame: funnel, then one of the three device entry
        points -- render_fused_insert (a remesh batch rides the frame),
        render_prepared (draw list unchanged) or render_fused --, each a
        replay of the renderer's graph for its gather bucket.  The frame's
        tensors are its own: later frames never write them.  With
        ``RenderConfig.temporal_hiz`` a frame whose camera and draw list
        are unchanged takes render_prepared_hiz: it culls against the
        previous such frame's pyramid when that frame had the same draw
        list and camera, else against an empty one.  In resident mode the
        frame is ``_render_frame_resident``'s; when the scene exceeds the
        resident caps the engine leaves resident mode for good and the
        frame goes on as a serial one with the camera already moved."""
        with prof.FRAME(self.device):
            out = self._serial_frame(dt)
        self._frame_bookkeeping(out.rendered_meshes)
        return out

    def _serial_frame(self, dt: float) -> FrameResult:
        if self.resident_stream:
            out = self._render_frame_resident(dt)
            if out is not None:
                return out
            self.resident_stream = False
            dt = 0.0
        if self.renderer._pipe_carry is not None:
            raise RuntimeError(
                "frames-in-flight pipeline is non-empty; call "
                "flush_pipeline() before mixing in serial render_frame")
        vp, sig, n, n_visible_meshes, cam_same = self._funnel(dt)
        with prof.DISPATCH:
            color, depth, stats = self._dispatch(vp, sig, cam_same)
        self._apply_stale_stash()
        return FrameResult(color, depth, stats, n, n_visible_meshes)

    def _dispatch(self, vp, sig, cam_same):
        """The serial frame's renderer call on the funnel's draw list:
        (color, depth, stats)."""
        cam = self.camera
        if self._pending_insert is not None:
            payload = self._pending_insert
            self._pending_insert = None
            out = self.renderer.render_fused_insert(
                self.pool.quads, self._last_visible_slots,
                self._last_counts_sel, self._last_positions_sel, vp,
                cam.position, payload, dir_mask=self._last_dir_mask)
            self._upload_cache = (sig, None)
            return out
        if self._upload_cache is not None and self._upload_cache[0] == sig:
            uploads = self._upload_cache[1]
            if uploads is None:
                # the draw list settled after changing (the fused calls do
                # not keep the expanded stream): expand once
                uploads = self.renderer.prepare_uploads(
                    self.pool.quads, self._last_visible_slots,
                    self._last_counts_sel, self._last_positions_sel,
                    dir_mask=self._last_dir_mask)
                self._upload_cache = (sig, uploads)
            if self.config.temporal_hiz and cam_same:
                # static frame: the previous frame's pyramid is exact for
                # the same camera, world and draw list; the first static
                # frame seeds with +inf (culls nothing)
                tsig = (sig, vp.tobytes())
                hiz1 = (self._prev_hiz
                        if self._prev_hiz is not None
                        and self._prev_hiz_sig == tsig
                        else self.renderer.empty_hiz())
                color, depth, stats, self._prev_hiz = (
                    self.renderer.render_prepared_hiz(
                        uploads, vp, cam.position, hiz1))
                self._prev_hiz_sig = tsig
                return color, depth, stats
            self._prev_hiz = None
            return self.renderer.render_prepared(uploads, vp, cam.position)
        out = self.renderer.render_fused(
            self.pool.quads, self._last_visible_slots,
            self._last_counts_sel, self._last_positions_sel,
            vp, cam.position, dir_mask=self._last_dir_mask)
        self._upload_cache = (sig, None)
        return out

    def render_frame_pipelined(self, dt: float = 0.016) -> FrameResult | None:
        """Frames-in-flight frame: run this frame's funnel, enter it with
        its stage A in the previous frame's raster launch (kernel K3;
        rendering/pipeline.py render_*_pipelined, each a replay of the
        renderer's graph for its gather bucket), and return the previous
        frame's FrameResult, or None on the first call.  Drain the last
        frame with flush_pipeline().  Every emitted frame equals
        render_frame's for the same camera sequence bit for bit, one frame
        later."""
        with prof.FRAME(self.device):
            out = self._pipelined_frame(dt)
        if out is not None:
            self._frame_bookkeeping(out.rendered_meshes)
        return out

    def _pipelined_frame(self, dt: float) -> FrameResult | None:
        vp, sig, n, n_visible_meshes, _cam_same = self._funnel(dt)
        cam = self.camera
        self._prev_hiz = None
        with prof.DISPATCH:
            if self._pending_insert is not None:
                # the fused insert+render path is serial-only: apply the
                # batch with the standalone scatter, in place, before the
                # step; the carried frame's stream is a gathered copy, not
                # a view of the pool, so the scatter cannot change it
                self.pool.dispatch_insert_payload(self._pending_insert)
                self._pending_insert = None
            if (self._upload_cache is not None
                    and self._upload_cache[0] == sig
                    and self._upload_cache[1] is not None):
                out = self.renderer.render_prepared_pipelined(
                    self._upload_cache[1], vp, cam.position)
            else:
                out, uploads = self.renderer.render_fused_pipelined(
                    self.pool.quads, self._last_visible_slots,
                    self._last_counts_sel, self._last_positions_sel,
                    vp, cam.position, dir_mask=self._last_dir_mask)
                self._upload_cache = (sig, uploads)
        self._apply_stale_stash()
        self._pipe_meta.append((n, n_visible_meshes))
        if out is None:
            return None
        color, depth, stats = out
        pn, pv = self._pipe_meta.popleft()
        return FrameResult(color, depth, stats, pn, pv)

    def flush_pipeline(self) -> FrameResult | None:
        """Drain the frames-in-flight pipeline: render and return the
        pending frame (None when the pipeline is empty)."""
        with prof.FRAME(self.device), prof.DISPATCH:
            out = self.renderer.pipeline_flush()
        if out is None:
            self._pipe_meta.clear()
            return None
        color, depth, stats = out
        pn, pv = self._pipe_meta.popleft()
        return FrameResult(color, depth, stats, pn, pv)

    # ----------------------------------------------------------- views
    def draw_list(self) -> DrawList:
        """The draw list of the last funnel (the last frame's, or the last
        view's): its arrays, which later funnels do not write."""
        return DrawList(self._last_visible_slots, self._last_counts_sel,
                        self._last_dir_mask, self._last_positions_sel,
                        int(self._last_n_visible))

    def _views_render(self) -> ViewsRender:
        """The mesh's render of views, made at its first use; from then on
        the pool notes the slots it writes, which the render's replicas
        take at each call (``ViewsRender.follow``)."""
        if self.mesh is None:
            raise RuntimeError("render_views needs an engine built with "
                               "mesh_cards")
        if self._views is None:
            self._views = ViewsRender(self.mesh, self.renderer)
            self.pool.written = set()
        return self._views

    def warm_views(self, views: int | None = None) -> None:
        """Every one-time cost of ``render_views`` with ``views`` views a
        call (by default the mesh's dp), in a fixed order: the pool's
        replicas on the other cards (peer copies), each dp row's NCCL
        communicator, then each gather bucket's graph on every card
        (``ViewsRender.warm``), on a one-chunk draw list with an identity
        camera.  The pool, the caches and every later frame are as
        without the call."""
        render = self._views_render()
        vcap = self.config.visible_chunks_cap
        c6 = np.zeros((vcap, 6), np.int32)
        c6[0] = self.pool.counts6[0]
        one = DrawList(np.zeros(vcap, np.int32), c6,
                       np.ones((vcap, 6), np.int32),
                       np.zeros((vcap, 3), np.int32), 1)
        eye, origin = np.eye(4, dtype=np.float32), np.zeros(3, np.float32)
        frames, _, _ = self.renderer.pack_views(
            [(one, eye, origin)] * (views or self.mesh.dp))
        self.pool.take_written()
        render.warm(self.pool.quads, frames)

    def render_views(self, poses, dt: float = 0.016) -> ViewsResult:
        """One call of ``len(poses)`` views, a multiple of the mesh's dp:
        each pose ``(position, yaw, pitch)`` in turn set on the camera and
        run through the funnel (``dt`` handed to the first alone; the
        world updates at the first view's position only, and a remesh
        batch lands in the pool by the standalone scatter), then every
        view rendered by one sharded call over the mesh
        (``ViewsRender``): shard (i, t) renders the views of dp row i on
        row band t from its card's replica of the pool.  The camera is left
        at the last pose.  Returns fresh tensors on the engine's device,
        which later calls never write; each view's frame is
        ``render_frame``'s at its pose bit for bit."""
        render = self._views_render()
        if self.resident_stream:
            raise RuntimeError("render_views runs the frustum draw list, "
                               "not the resident stream")
        if not poses or len(poses) % self.mesh.dp:
            raise ValueError(f"{len(poses)} views over dp = {self.mesh.dp}")
        cam = self.camera
        views = []
        with prof.FRAME(self.device):
            for k, (position, yaw, pitch) in enumerate(poses):
                cam.position = np.array(position, np.float32)
                cam.yaw, cam.pitch = float(yaw), float(pitch)
                self._hold_world = k > 0
                try:
                    vp = self._funnel(dt if k == 0 else 0.0)[0]
                finally:
                    self._hold_world = False
                if self._pending_insert is not None:
                    self.pool.dispatch_insert_payload(self._pending_insert)
                    self._pending_insert = None
                views.append((self.draw_list(), vp, cam.position.copy()))
            with prof.VIEWS_PACK:
                frames, cap, quads = self.renderer.pack_views(views)
            prof.VIEWS.add(len(views))
            prof.VIEW_QUADS.add(quads)
            with prof.VIEWS_DISPATCH:
                color, depth, stats, reduced = render(
                    self.pool.quads, self.pool.take_written(), frames, cap)
            self._apply_stale_stash()
        self._frame_bookkeeping(sum(dl.n for dl, _, _ in views))
        return ViewsResult(color, depth, stats, reduced)

    def _frame_bookkeeping(self, n) -> None:
        """``log_fps``: a line for a frame whose span (``frame``, host
        clock) took over ``slow_frame_ms``, and once a second the frames
        completed a second, counted by the frames' end markers on the card
        (on the CPU a frame completes with its call)."""
        if not self.log_fps or not prof.TRACER.enabled:
            return
        frame_ms = prof.TRACER.last_frame_ns / 1e6
        if frame_ms > self.slow_frame_ms:
            print(f"slow frame: {frame_ms:.1f} ms (visible={n})")
        now = time.perf_counter()
        if now - self._fps_t0 >= 1.0:
            done = prof.TRACER.completed
            fps = (done - self._fps_done) / (now - self._fps_t0)
            print(f"FPS: {fps:.1f} | chunks: {self.world.chunk_count()} "
                  f"| rendered meshes: {n}")
            self._fps_done = done
            self._fps_t0 = now
