"""The frame loop in PyTorch: world streaming, the device mesh pool, the
culling funnel and the per-frame render call.

Counterpart of ``differential_projection_voxel_renderer_tpu/app/engine.py``
on its default serial path.  The host logic (streaming, remeshing, the
culling funnel, draw-list build, the pool's host bookkeeping) is carried
over as it is, on the shared host layers of the reference package; only
the device calls change.  Every device tensor lives on the ``device`` the
engine was built with.  Not ported yet (they raise NotImplementedError):
the resident superset stream, device meshing and frames in flight; the
one-frame-stale pool mode is left out with them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from differential_projection_voxel_renderer_tpu.meshing.greedy import (
    mesh_chunk,
)
from differential_projection_voxel_renderer_tpu.models.camera import (
    Camera,
    CameraController,
)
from differential_projection_voxel_renderer_tpu.models.world import (
    World,
    WorldConfig,
)
from differential_projection_voxel_renderer_tpu.ops.culling import (
    HorizonCullingConfig,
    horizon_cull_mask,
    sort_front_to_back,
)
from differential_projection_voxel_renderer_tpu.ops.occlusion import (
    occlusion_pass,
    project_chunk_rects,
)
from differential_projection_voxel_renderer_tpu.utils.config import (
    CHUNK_SIZE,
    QUADS_PER_CHUNK_CAP,
    RenderConfig,
)
from differential_projection_voxel_renderer_tpu.utils.profiling import (
    FUNCTION_COUNTERS,
)

from ..rendering.pipeline import Renderer, _c6_of, apply_insert_payload

# RenderConfig and WorldConfig are re-exported: a caller of the port builds
# an Engine naming this package only
__all__ = ["Engine", "FrameResult", "QuadPool", "RenderConfig", "WorldConfig"]


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
    """Device mesh cache: packed quads per chunk slot (int32 words) plus a
    device mirror of the per-direction counts (``counts6_dev``), kept in
    step by every device scatter.  Host bookkeeping as in the reference."""

    # the fused insert+render payload shape (rendering/pipeline.Renderer)
    INSERT_KP = Renderer.INSERT_KP
    INSERT_MC = Renderer.INSERT_MC
    INSERT_FP = Renderer.INSERT_FP

    def __init__(self, slots: int = 4096, qcap: int = QUADS_PER_CHUNK_CAP,
                 *, device):
        if slots > 32767:
            raise ValueError("QuadPool slots must be <= 32767 "
                             "(int16 draw-list upload)")
        self.device = torch.device(device)
        self.slots = slots
        self.qcap = qcap
        self.quads = torch.zeros((slots, qcap), dtype=torch.int32,
                                 device=self.device)
        self.counts6_dev = torch.zeros((slots, 6), dtype=torch.int32,
                                       device=self.device)
        self.counts = np.zeros(slots, np.int32)
        self.counts6 = np.zeros((slots, 6), np.int32)
        self.positions = np.zeros((slots, 3), np.int32)
        self.by_pos: dict[tuple[int, int, int], int] = {}
        self._free: list[int] = list(range(slots - 1, -1, -1))
        self.overflow_drops = 0
        self._used = np.zeros(slots, bool)
        self._lookup_cache: tuple | None = None

    @classmethod
    def from_numpy(cls, quads, counts6, positions, by_pos, *, device):
        """A pool holding the given state: ``quads`` u32[S, Q] rows,
        ``counts6`` i32[S, 6] per-direction counts, ``positions`` i32[S, 3],
        ``by_pos`` {chunk position: slot}.  The free list holds the unused
        slots, lowest first."""
        quads = np.asarray(quads, np.uint32)
        slots, qcap = quads.shape
        pool = cls(slots, qcap, device=device)
        pool.quads = _words(quads).to(pool.device)
        pool.counts6 = np.array(counts6, np.int32)
        pool.counts6_dev = torch.from_numpy(pool.counts6.copy()).to(
            pool.device)
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
        row_t = _words(row).to(self.device)
        self.quads[slot] = row_t
        self.counts6_dev[slot] = _c6_of(
            row_t[None, :], torch.tensor([n], device=self.device))[0]
        self.counts[slot] = n
        self.counts6[slot] = _dir_counts(row[:n])
        self.positions[slot] = key
        self._lookup_cache = None

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
        slots = np.zeros(k, np.int32)
        counts = np.zeros(k, np.int32)
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
        starts = np.cumsum(counts) - counts
        total = int(counts.sum())
        mc = 512 if counts.max(initial=0) <= 512 else self.qcap
        kp = 16 if k <= 16 else (64 if k <= 64 else 512)
        if kp != k:  # pad with idempotent duplicates of entry 0
            slots = np.concatenate([slots, np.full(kp - k, slots[0],
                                                   np.int32)])
            starts = np.concatenate([starts, np.full(kp - k, starts[0],
                                                     np.int64)])
            counts = np.concatenate([counts, np.full(kp - k, counts[0],
                                                     np.int32)])
        fp = 1 << max(11, (max(total, 1) - 1).bit_length())
        packed = np.zeros(3 * kp + fp, np.uint32)
        packed[:kp] = slots.astype(np.uint32)
        packed[kp:2 * kp] = starts.astype(np.uint32)
        packed[2 * kp:3 * kp] = counts.astype(np.uint32)
        if total:
            packed[3 * kp:3 * kp + total] = np.concatenate(parts)
        self.dispatch_insert_payload(packed, kp=kp, mc=mc)
        self._lookup_cache = None

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
        total = sum(len(q) for _, q in items if q is not None)
        if total > fp:
            return None
        k = len(items)
        slots = np.zeros(kp, np.int32)
        counts = np.zeros(kp, np.int32)
        parts = []
        for i, (pos, quads) in enumerate(items):
            key = tuple(int(c) for c in pos)
            slot = self._slot_for(key)
            n = 0
            if quads is not None:
                n = len(quads)
                parts.append(np.asarray(quads, np.uint32))
                self.counts6[slot] = _dir_counts(parts[-1])
            else:
                self.counts6[slot] = 0
            slots[i] = slot
            counts[i] = n
            self.counts[slot] = n
            self.positions[slot] = key
        slots[k:] = slots[0]
        counts[k:] = counts[0]
        starts = np.zeros(kp, np.int64)
        starts[:k] = np.cumsum(counts[:k]) - counts[:k]
        starts[k:] = starts[0]
        packed = np.zeros(3 * kp + fp, np.uint32)
        packed[:kp] = slots.astype(np.uint32)
        packed[kp:2 * kp] = starts.astype(np.uint32)
        packed[2 * kp:3 * kp] = counts.astype(np.uint32)
        if total:
            packed[3 * kp:3 * kp + total] = np.concatenate(parts)
        self._lookup_cache = None
        return packed

    def dispatch_insert_payload(self, payload: np.ndarray,
                                kp: int | None = None,
                                mc: int | None = None) -> None:
        """Apply a prepared payload with a standalone in-place scatter."""
        apply_insert_payload(
            self.quads, self.counts6_dev, _words(payload).to(self.device),
            k=self.INSERT_KP if kp is None else kp,
            mc=self.INSERT_MC if mc is None else mc)

    def adopt_device_arrays(self, quads, counts6_dev) -> None:
        """Rebind the device pool tensors after a fused insert+render."""
        self.quads = quads
        self.counts6_dev = counts6_dev

    def remove(self, pos) -> None:
        key = tuple(int(c) for c in pos)
        slot = self.by_pos.pop(key, None)
        if slot is not None:
            self.counts[slot] = 0
            self.counts6[slot] = 0
            self._used[slot] = False
            self._free.append(slot)
        self._lookup_cache = None

    def retain(self, predicate) -> None:
        """Drop entries whose position fails the predicate (a dict/set is
        the fast path: direct membership)."""
        if isinstance(predicate, (dict, set, frozenset)):
            keys = [k for k in self.by_pos if k not in predicate]
        else:
            keys = [k for k in self.by_pos if not predicate(k)]
        for key in keys:
            self.remove(key)

    @staticmethod
    def _pack_keys(pos: np.ndarray) -> np.ndarray:
        p = np.asarray(pos, np.int64)
        b = np.int64(1 << 20)
        return (((p[:, 0] + b) << 42) | ((p[:, 1] + b) << 21)
                | (p[:, 2] + b))

    def lookup_slots(self, pos: np.ndarray):
        """Vectorized pos -> slot join: (slots i32[N], has bool[N])."""
        if self._lookup_cache is None:
            used = np.nonzero(self._used)[0].astype(np.int32)
            keys = self._pack_keys(self.positions[used])
            o = np.argsort(keys)
            self._lookup_cache = (keys[o], used[o])
        pk, ps = self._lookup_cache
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
    #                      bin_overflow, subpixel_culled, 0
    rendered_meshes: int
    visible_chunks: int

    def color_numpy(self) -> np.ndarray:
        return np.array(self.color.cpu()).view(np.uint32)

    def depth_numpy(self) -> np.ndarray:
        return np.array(self.depth.cpu())


class Engine:
    """Owns world + camera + mesh pool + renderer; drives frames."""

    def __init__(self, render_config: RenderConfig | None = None,
                 world_config: WorldConfig | None = None,
                 pool_slots: int = 4096,
                 horizon_config: HorizonCullingConfig | None = None,
                 device_meshing: bool = False,
                 resident_stream: bool | None = None, *, device):
        if resident_stream:
            raise NotImplementedError("resident_stream is not ported yet")
        if device_meshing:
            raise NotImplementedError("device_meshing is not ported yet")
        self.device = torch.device(device)
        self.config = render_config or RenderConfig()
        self.world = World(world_config or WorldConfig(
            view_distance=12, frustum_culling=True, max_chunks_per_frame=16))
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
        self._fps_frames = 0
        self._fps_t0 = time.perf_counter()
        self._neighbor_offsets = [
            (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)
        ]
        self._seen_world_version = -1
        self._seen_unload_version = -1
        self._seen_vp = None
        self._visible_cache = None
        self._upload_cache = None
        # streaming fast path: fold small remesh batches into the frame
        # (QuadPool.prepare_insert_payload + render_fused_insert)
        self.fused_insert = True
        self._pending_insert: np.ndarray | None = None

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
        missing = np.asarray(vis_pos[~has], np.int64)
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
        to_mesh = sorted(set(to_mesh))
        batch = []
        for pos in to_mesh:
            chunk = self.world.chunks.get(pos)
            if chunk is None:
                continue
            batch.append((pos, mesh_chunk(chunk, self.world.chunks)))
        if defer and self.fused_insert and self._pending_insert is None:
            # fold the insert into this frame's render call
            payload = self.pool.prepare_insert_payload(batch)
            if payload is not None:
                self._pending_insert = payload
                return len(to_mesh)
        self.pool.insert_many(batch)
        return len(to_mesh)

    def prime(self) -> None:
        """Generate + mesh everything currently visible."""
        frustum = self.camera.extract_frustum()
        visible = self.world.get_visible_chunks_frustum(
            self.camera.position, frustum)
        self._remesh(visible)

    def _dir_keep_mask(self, positions, cam_pos) -> np.ndarray:
        """Per-chunk face-direction keep mask [n, 6]: 0 where every quad of
        the direction is provably backfacing (a strict subset of the
        device backface cull, exact in f32)."""
        if not self.config.backface_culling:
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
        draw-list arrays and returns (vp, sig, n, n_visible, cam_same)."""
        cam = self.camera
        self.controller.update_camera(cam, dt)
        self.world.update(cam.position)

        vp_now = cam.view_projection_matrix()
        world_v = self.world.version
        cam_same = (self._seen_vp is not None
                    and np.array_equal(self._seen_vp, vp_now))
        if (cam_same and world_v == self._seen_world_version
                and self._visible_cache is not None):
            vis_pos = self._visible_cache
        else:
            frustum = cam.extract_frustum()
            vis_pos = self.world.get_visible_positions(cam.position, frustum)
            self._visible_cache = vis_pos
            if not (cam_same and world_v == self._seen_world_version):
                self._remesh_positions(vis_pos)
                if self.world.unload_version != self._seen_unload_version:
                    self.pool.retain(self.world.chunks)
                    self._seen_unload_version = self.world.unload_version
            self._seen_vp = vp_now.copy()
            self._seen_world_version = self.world.version

        slots_all, has = self.pool.lookup_slots(vis_pos)
        hs = slots_all[has]
        nz = self.pool.counts[hs] > 0
        slots = hs[nz]
        centers = (vis_pos[has][nz].astype(np.float32) * CHUNK_SIZE + 16.0
                   if len(slots) else np.zeros((0, 3), np.float32))
        n_visible_meshes = len(slots)
        vp = cam.view_projection_matrix()

        if n_visible_meshes:
            order = sort_front_to_back(centers, cam.position)
            slots = slots[order]
            centers = centers[order]
            if self.enable_horizon_culling:
                keep = horizon_cull_mask(centers, cam.position,
                                         self.horizon_config)
                FUNCTION_COUNTERS.add("chunks_horizon_culled",
                                      int((~keep).sum()))
                slots, centers = slots[keep], centers[keep]
            if self.enable_occlusion_culling and len(slots):
                rects, near, _ = project_chunk_rects(
                    centers, vp, self.config.width, self.config.height)
                d2 = ((centers - cam.position[None, :]) ** 2).sum(-1)
                use_occ = d2 >= (CHUNK_SIZE * 2.0) ** 2
                keep = occlusion_pass(rects, near, use_occ,
                                      self.config.width, self.config.height,
                                      epsilon=self.occlusion_epsilon)
                FUNCTION_COUNTERS.add("chunks_occlusion_culled",
                                      int((~keep).sum()))
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
        sig = (self.world.version, visible_slots[:n].tobytes(),
               counts_sel[:n].tobytes(), mask_sel[:n].tobytes())
        return vp, sig, n, n_visible_meshes, cam_same

    def render_frame(self, dt: float = 0.016) -> FrameResult:
        """One serial frame: funnel, then one of the three device entry
        points -- render_fused_insert (a remesh batch rides the frame),
        render_prepared (draw list unchanged) or render_fused."""
        frame_t0 = time.perf_counter()
        vp, sig, n, n_visible_meshes, _cam_same = self._funnel(dt)
        cam = self.camera
        if self._pending_insert is not None:
            payload = self._pending_insert
            self._pending_insert = None
            out = self.renderer.render_fused_insert(
                self.pool.quads, self.pool.counts6_dev,
                self._last_visible_slots, self._last_counts_sel,
                self._last_positions_sel, vp, cam.position, payload,
                dir_mask=self._last_dir_mask)
            if out is not None:
                pool2, c6b, color, depth, stats = out
                self.pool.adopt_device_arrays(pool2, c6b)
                self._upload_cache = (sig, None)
                self._frame_bookkeeping(stats, n, frame_t0)
                return FrameResult(color, depth, stats, n, n_visible_meshes)
            # fallback layout (truncated draw list): standalone scatter, then
            # the normal render path below
            self.pool.dispatch_insert_payload(payload)
        if self._upload_cache is not None and self._upload_cache[0] == sig:
            uploads = self._upload_cache[1]
            if uploads is None:
                # the draw list settled after streaming frames (whose fused
                # calls do not keep the expanded stream): expand once
                uploads = self.renderer.prepare_uploads(
                    self.pool.quads, self._last_visible_slots,
                    self._last_counts_sel, self._last_positions_sel,
                    dir_mask=self._last_dir_mask)
                self._upload_cache = (sig, uploads)
            color, depth, stats = self.renderer.render_prepared(
                uploads, vp, cam.position)
        else:
            color, depth, stats, uploads = self.renderer.render_fused(
                self.pool.quads, self._last_visible_slots,
                self._last_counts_sel, self._last_positions_sel,
                vp, cam.position, dir_mask=self._last_dir_mask,
                counts6_dev=self.pool.counts6_dev)
            self._upload_cache = (sig, uploads)
        self._frame_bookkeeping(stats, n, frame_t0)
        return FrameResult(color, depth, stats, n, n_visible_meshes)

    def render_frame_pipelined(self, dt: float = 0.016):
        raise NotImplementedError("frames in flight are not ported yet")

    def _frame_bookkeeping(self, stats, n, frame_t0) -> None:
        if FUNCTION_COUNTERS.enabled:
            st = stats.cpu().numpy()
            FUNCTION_COUNTERS.add("render_frames")
            FUNCTION_COUNTERS.add("quads_gathered", int(st[0]))
            FUNCTION_COUNTERS.add("quads_rasterized", int(st[1]))
            FUNCTION_COUNTERS.add("quads_culled", int(st[0]) - int(st[1]))
            FUNCTION_COUNTERS.add("quads_subpixel_culled", int(st[4]))
        if self.log_fps:
            self._fps_frames += 1
            now = time.perf_counter()
            frame_ms = (now - frame_t0) * 1000.0
            if frame_ms > self.slow_frame_ms:
                print(f"slow frame: {frame_ms:.1f} ms (visible={n})")
            if now - self._fps_t0 >= 1.0:
                fps = self._fps_frames / (now - self._fps_t0)
                print(f"FPS: {fps:.1f} | chunks: {self.world.chunk_count()} "
                      f"| rendered meshes: {n}")
                self._fps_frames = 0
                self._fps_t0 = now
