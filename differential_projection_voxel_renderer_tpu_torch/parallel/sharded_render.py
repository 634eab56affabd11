"""Row bands and camera batches over a mesh of cards.

Counterpart of ``differential_projection_voxel_renderer_tpu/parallel/
sharded_render.py``, which shards a camera batch over the ``dp`` axis and
framebuffer row bands over the ``tp`` axis of a device mesh:

- ``make_mesh`` lays n devices out as a (dp, tp) ``DeviceMesh`` with the
  reference's factorization, row-major as JAX's ``Mesh`` lays them: shard
  (i, t) is device ``i * tp + t``.  By default they are the first n CUDA
  cards, all distinct; a caller may list the devices itself, the same
  device several times included (a CPU mesh for the tests, one card for a
  decomposition on one card);
- every shard runs on its own card, all at once: its step is captured into
  a CUDA graph on that card at the first call (``rendering/graphs.py
  CapturedCall``), and a call copies each shard's inputs in and then
  replays every card's graph from this one host thread.  The eager step
  is host-bound (~470 launches a frame), and driven from one host thread
  a card it was slower than on one card: each torch op releases and
  retakes the interpreter lock, so four threads hand it over at every op
  (``benches/multicard.py`` times both).
  On the CPU the shards run in turn, eagerly.  The scene (pool, counts,
  positions) is replicated on every device (``replicate`` makes the form a
  caller keeps across calls) and the camera batch is split over dp;
- a ``tp`` shard is one ``render_step`` on its rows (``band_y0``/
  ``band_h``: the quads that touch the band, rasterized by one K2 launch
  into a band-sized frame at global pixel NDC), and the bands stacked
  equal the full frame bit for bit;
- the reference's one collective, ``psum(count, "tp") // tp`` of the
  bands' rasterized counts, is ``all_reduce_sum`` over each dp row's tp
  shards -- an NCCL all-reduce in this one process where those are
  distinct cards, else the plain sum -- then divided by tp on each shard;
- the outputs are gathered on the mesh's first device by peer copies, as
  ``np.asarray`` gathers a sharded ``jax.Array``;
- ``ViewsRender`` is the same layout on the engine's own path
  (``Engine.render_views``): each view's draw list from the engine's
  funnel, the serial path's expansion and step on each band, one graph a
  (gather bucket, shard), and the pool's replicas following the engine's
  pool.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import projection as proj_ops
from ..ops.raster import pick_tile
from ..ops.shading import build_quad_color_tables
from ..ops.texture import TextureAtlas
from ..rendering.graphs import CapturedCall
from ..rendering.pipeline import (render_step, resolve_device,
                                  views_band_frame)
from ..utils import profiling as prof


class DeviceMesh:
    """A (dp, tp) mesh: ``devices`` an object array [dp, tp] of indexed
    ``torch.device``s.  Unpacks as (dp, tp)."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def dp(self) -> int:
        return self.devices.shape[0]

    @property
    def tp(self) -> int:
        return self.devices.shape[1]

    def __iter__(self):
        return iter(self.devices.shape)

    def __repr__(self) -> str:
        return (f"DeviceMesh(dp={self.dp}, tp={self.tp}, devices="
                f"{[str(d) for d in self.flat]})")

    @property
    def flat(self) -> list[torch.device]:
        """The devices in mesh order (shard (i, t) at i * tp + t)."""
        return list(self.devices.reshape(-1))

    @property
    def distinct(self) -> list[torch.device]:
        """Each device once, in mesh order."""
        return list(dict.fromkeys(self.flat))


def _indexed(dev) -> torch.device:
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int | None = None, devices=None) -> DeviceMesh:
    """The (dp, tp) mesh of ``n_devices`` devices that the reference's
    ``make_mesh`` takes: tp gets the larger factor (framebuffer bands are
    the finer-grained axis).  ``devices`` lists the devices (the first
    ``n_devices`` are taken, all of them by default; one may appear more
    than once); without it they are the first ``n_devices`` CUDA cards
    (by default all of them), and asking for more cards than there are
    raises: the mesh never takes fewer cards or the CPU."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = n_devices or count
        if n < 1 or n > count:
            raise RuntimeError(f"a mesh of {n_devices or 'all'} CUDA cards, "
                               f"and {count} are available")
        devs = [torch.device("cuda", k) for k in range(n)]
    else:
        devs = [_indexed(d) for d in devices]
        n = n_devices or len(devs)
        if not 1 <= n <= len(devs):
            raise ValueError(f"a mesh of {n} devices from {len(devs)} listed")
        devs = devs[:n]
    dp = 1
    for cand in (4, 3, 2):
        if n % cand == 0 and n // cand > 1:
            dp = n // cand if cand >= n // cand else cand
            break
    dp = max(1, min(dp, n))
    while n % dp:
        dp -= 1
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return DeviceMesh(grid.reshape(dp, n // dp))


class Replicated:
    """A tensor with one copy on each distinct device of a mesh: the form
    of a replicated input that a caller keeps across calls (JAX:
    ``jax.device_put`` with a replicated sharding), taken as it is."""

    def __init__(self, copies: dict):
        self.copies = copies

    def on(self, dev: torch.device) -> torch.Tensor:
        return self.copies[dev]


def replicate(mesh: DeviceMesh, x) -> Replicated:
    """``x`` copied once to each distinct device of ``mesh`` (a device
    that holds it already keeps it); a ``Replicated`` is returned as it
    is."""
    if isinstance(x, Replicated):
        return x
    return Replicated({d: x.to(d) for d in mesh.distinct})


def all_reduce_sum(counts: list) -> list:
    """The sum of ``counts`` (one int32 tensor a shard, each on its
    shard's device, all of one shape) on every shard.  Distinct CUDA cards
    reduce in place by one NCCL all-reduce in this process
    (``torch.cuda.nccl.all_reduce``, on each card's current stream); other
    devices (the CPU, or a card listed twice) take the plain sum, copied
    to each shard's device."""
    devs = [c.device for c in counts]
    if len(counts) == 1:
        return counts
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        from torch.cuda import nccl

        nccl.all_reduce(counts)
        return counts
    total = functools.reduce(torch.add, (c.to(devs[0]) for c in counts))
    return [total.to(d) for d in devs]


def _color_tables(color_tables, devices) -> dict:
    """Shading tables (numpy, ops/shading.build_quad_color_tables; the
    default atlas when None) as the step's tables on each device."""
    if color_tables is None:
        color_tables = build_quad_color_tables(TextureAtlas().kernel_tables())
    return {d: proj_ops.color_table_tensors(color_tables, d)
            for d in devices}


def _render_one_camera(pool, counts_all, positions, visible_slots,
                       n_visible, view_proj, cam_pos, color_tables, *,
                       width: int, height: int, gather_cap: int,
                       render_cap: int, band_y0: int, band_h: int,
                       span_mode: bool = False, tile_k_cap: int = 8192):
    """One camera's gather and render step on one row band: the pool rows
    of the first ``n_visible`` visible slots, ``counts_all`` quads each,
    flattened to a ``gather_cap`` stream with a searchsorted over the
    per-chunk totals.  Returns (color, depth [band_h, W], the band's
    rasterized count)."""
    dev = pool.device
    vcap = visible_slots.shape[0]
    sel = torch.clamp(visible_slots, 0, pool.shape[0] - 1).long()
    counts = torch.where(torch.arange(vcap, device=dev) < n_visible,
                         counts_all[sel], 0).long()
    world = positions[sel].float() * 32.0
    chunk_world = tuple(world[:, a] for a in range(3))
    cum = torch.cumsum(counts, 0)
    total = cum[-1]
    i = torch.arange(gather_cap, device=dev)
    chunk_of = torch.clamp(torch.searchsorted(cum, i, right=True), 0,
                           vcap - 1)
    base = torch.where(chunk_of > 0, cum[torch.clamp(chunk_of - 1, min=0)],
                       0)
    within = torch.clamp(i - base, 0, pool.shape[1] - 1)
    quads = pool[sel[chunk_of], within]
    wq = proj_ops.quad_world_from_slots(chunk_world, chunk_of)
    tile_h, tile_w = pick_tile(height, width)
    color, depth, stats = render_step(
        quads, torch.stack(wq), torch.clamp(total, max=gather_cap),
        view_proj, cam_pos, color_tables=color_tables, width=width,
        height=height, tile_h=tile_h, tile_w=tile_w, render_cap=render_cap,
        span_mode=span_mode, backface_culling=True, tile_k_cap=tile_k_cap,
        band_y0=band_y0, band_h=band_h)
    return color, depth, stats[1]


def _reduce_rows(mesh: DeviceMesh, shards: dict) -> None:
    """``psum(count, "tp") // tp``: each dp row's band counts (a shard's
    outputs' third item) summed over its tp shards (``all_reduce_sum``)
    and divided by tp, on every shard, in place of the band counts."""
    dp, tp = mesh
    for i in range(dp):
        row = all_reduce_sum([shards[i, t][2] for t in range(tp)])
        for t in range(tp):
            s = shards[i, t]
            shards[i, t] = (*s[:2], row[t] // tp, *s[3:])


def _stack_bands(mesh: DeviceMesh, shards: dict, height: int,
                 width: int) -> tuple:
    """The shards' bands (a shard's outputs' first two items: [color] and
    [depth] a camera) stacked into fresh tensors on the mesh's first
    device by peer copies: color i32[B, H, W], depth f32[B, H, W]."""
    per = len(shards[0, 0][0])
    bh = height // mesh.tp
    dev = mesh.devices[0, 0]
    color = torch.empty((mesh.dp * per, height, width), dtype=torch.int32,
                        device=dev)
    depth = torch.empty((mesh.dp * per, height, width), dtype=torch.float32,
                        device=dev)
    for (i, t), (cs, ds, *_) in shards.items():
        for j, (c, d) in enumerate(zip(cs, ds)):
            color[i * per + j, t * bh:(t + 1) * bh].copy_(c)
            depth[i * per + j, t * bh:(t + 1) * bh].copy_(d)
    return color, depth


class _Shards:
    """Runs a mesh's shards: ``step(key, *fixed, *inputs)`` for each shard
    key on its device, each from its ``CapturedCall`` (rendering/
    graphs.py; rebuilt when its fixed tensors or input shapes change): on
    a card its step runs eagerly at its first call and is captured into a
    CUDA graph on that card, and a later call replays it.  Every shard's
    inputs are copied in first (a copy from another card waits on that
    card's queue, so none may wait behind a replay), then every shard runs,
    all from the calling thread, one replay after another.  A replay's
    outputs are its graph's own memory, not copied here: ``gather`` copies
    them to the first device.  On the CPU each shard runs its eager step
    in turn."""

    def __init__(self, step):
        self.step = step
        self.graphs: dict = {}

    def run(self, jobs) -> dict:
        """``jobs``: [(key, device, fixed tensors on the device, inputs on
        any device)]; returns {key: the step's outputs}, on a card the
        graph's memory, overwritten by the next call."""
        return self.replay(self.load(jobs))

    def load(self, jobs) -> list:
        """Every job's inputs copied into its graph's buffers (the graph
        made where there is none for its fixed tensors and input shapes):
        [(key, graph)] for ``replay``."""
        ready = []
        for key, dev, fixed, inputs in jobs:
            g = self.graphs.get(key)
            if g is None or not g.matches(fixed, inputs):
                g = self.graphs[key] = CapturedCall(
                    functools.partial(self.step, key), fixed, inputs,
                    device=dev)
            for i, x in enumerate(inputs):
                g.load(i, x)
            ready.append((key, g))
        return ready

    @staticmethod
    def replay(ready) -> dict:
        return {key: g.run(copy=False) for key, g in ready}


class ShardedRender:
    """The dp x tp render of a camera batch (``make_sharded_render``).
    Calling it runs ``bands``, ``reduce`` and ``gather``; the bench times
    each alone, and ``step`` is a shard's eager step."""

    def __init__(self, mesh: DeviceMesh, *, width: int, height: int,
                 gather_cap: int, render_cap: int, tile_k_cap: int,
                 color_tables, span_mode: bool):
        if height % (mesh.tp * 8):
            raise ValueError("height must split into 8-aligned bands")
        self.mesh = mesh
        self.band_h = height // mesh.tp
        self.tables = _color_tables(color_tables, mesh.distinct)
        self.kw = dict(width=width, height=height, gather_cap=gather_cap,
                       render_cap=render_cap, tile_k_cap=tile_k_cap,
                       span_mode=span_mode)
        self.shards = _Shards(self.step)
        # this function's copies of a scene input that is not replicated,
        # by (input, device): refilled each call, so the graphs' addresses
        # hold
        self._copies: dict = {}

    def step(self, key, pool, counts, positions, visible_slots, n_visible,
             view_proj, cam_pos):
        """Shard ``key`` = (i, t)'s eager step on its device: each camera
        of its dp row on its band.  Returns ([color [band_h, W] a camera],
        [depth a camera], the bands' counts i32[B / dp])."""
        dev = pool.device
        outs = [_render_one_camera(
            pool, counts, positions, visible_slots[j], n_visible[j],
            view_proj[j], cam_pos[j], self.tables[dev],
            band_y0=key[1] * self.band_h, band_h=self.band_h, **self.kw)
            for j in range(visible_slots.shape[0])]
        return ([c for c, _, _ in outs], [d for _, d, _ in outs],
                torch.stack([n for _, _, n in outs]))

    def _scene_on(self, k: int, x, dev: torch.device) -> torch.Tensor:
        if isinstance(x, Replicated):
            return x.on(dev)
        if x.device == dev:
            return x
        buf = self._copies.get((k, dev))
        if buf is None or buf.shape != x.shape or buf.dtype != x.dtype:
            buf = self._copies[k, dev] = torch.empty(x.shape, dtype=x.dtype,
                                                     device=dev)
        return buf.copy_(x)

    def bands(self, pool, counts, positions, visible_slots, n_visible,
              view_proj, cam_pos) -> dict:
        """Each shard's outputs on its device, the shards at once:
        {(i, t): ([color [band_h, W] a camera], [depth a camera], the
        bands' counts i32[B / dp])}, shard (i, t) rendering cameras
        i * B / dp .. (i + 1) * B / dp - 1 on rows t * band_h ...  On cards
        the graphs' own memory, valid until the next call."""
        b = visible_slots.shape[0]
        dp, tp = self.mesh
        if b % dp:
            raise ValueError(f"a batch of {b} cameras over dp = {dp}")
        per = b // dp
        scene = (pool, counts, positions)
        jobs = []
        for i in range(dp):
            cams = [x[i * per:(i + 1) * per] for x in (
                visible_slots, n_visible, view_proj, cam_pos)]
            for t in range(tp):
                dev = self.mesh.devices[i, t]
                fixed = [self._scene_on(k, x, dev)
                         for k, x in enumerate(scene)]
                jobs.append(((i, t), dev, fixed, cams))
        return self.shards.run(jobs)

    def reduce(self, shards: dict) -> None:
        """``psum(count, "tp") // tp``: each dp row's band counts summed
        over its tp shards (``all_reduce_sum``) and divided by tp, on every
        shard, in place of the band counts."""
        _reduce_rows(self.mesh, shards)

    def gather(self, shards: dict) -> tuple:
        """The shards' outputs copied into fresh tensors on the mesh's
        first device (the one copy out of the graphs' memory): color
        i32[B, H, W], depth f32[B, H, W] and each dp row's count, i32[B]."""
        per = len(shards[0, 0][0])
        color, depth = _stack_bands(self.mesh, shards, self.kw["height"],
                                    self.kw["width"])
        count = torch.empty(self.mesh.dp * per, dtype=torch.int32,
                            device=color.device)
        for (i, t), (_, _, n) in shards.items():
            if t == 0:
                count[i * per:(i + 1) * per].copy_(n)
        return color, depth, count

    def __call__(self, *args) -> tuple:
        shards = self.bands(*args)
        self.reduce(shards)
        return self.gather(shards)


def make_sharded_render(mesh: DeviceMesh, *, width: int, height: int,
                        gather_cap: int = 8192, render_cap: int = 4096,
                        tile_k_cap: int = 8192, color_tables=None,
                        span_mode: bool = False) -> ShardedRender:
    """The dp x tp render of a camera batch over ``mesh`` (``make_mesh``).
    Returns ``fn(pool, counts, positions, visible_slots, n_visible,
    view_proj, cam_pos)``:

    - pool i32[P, QCAP] quad words, counts i32[P], positions i32[P, 3]:
      replicated (tensors on any device, or ``replicate``'s form, which is
      not copied again);
    - visible_slots i32[B, VCAP], n_visible i32[B], view_proj
      f32[B, 4, 4], cam_pos f32[B, 3], B a multiple of dp: split over dp;

    and it returns, on the mesh's first device, color i32[B, H, W], depth
    f32[B, H, W] (each the tp bands stacked) and i32[B], the sum of the
    bands' rasterized counts divided by tp (each band counts the quads
    that touch it).  On cards each shard's step is replayed from its CUDA
    graph (the first call, or one with other shapes or another replicated
    scene, captures it).  ``tile_k_cap`` is the reference's per-camera
    binning cap (there fixed at its default, 8192), here a keyword so that
    a 720p frame fits.  ``span_mode`` renders every band in span mode."""
    return ShardedRender(mesh, width=width, height=height,
                         gather_cap=gather_cap, render_cap=render_cap,
                         tile_k_cap=tile_k_cap, color_tables=color_tables,
                         span_mode=span_mode)


class ViewsRender:
    """The sharded render of the engine's views (``Engine.render_views``):
    a batch of B views over a (dp, tp) mesh, each view's draw list from
    the engine's own funnel, shard (i, t) rendering views i * B / dp ..
    (i + 1) * B / dp - 1 on rows t * band_h ..  Its step is the serial
    path's on a band: each view's draw list and face-direction masks are
    expanded as ``render_fused`` expands them, then ``render_step`` runs
    with ``band_y0``/``band_h`` (``pipeline.views_band_frame``), so the
    stacked bands of a view are ``render_frame``'s frame of its pose bit
    for bit.  Its shards (``_Shards``), its all-reduce and its gather of
    the bands are the ``ShardedRender``'s.

    Its graphs are one a (gather bucket, shard): a call takes the bucket
    of its largest stream from the renderer's ladder, and ``warm``
    captures every bucket on every card in a fixed order, so that no call
    after it captures.  The pool is the engine's on the mesh's first
    device and a replica on each other card (``follow``), brought up to
    date before the shards run: the rows written since the last call, or
    the whole pool when the engine's pool tensor is another.  Everything
    is issued from the calling thread.  A card's replay, its all-reduce
    and its copy into the first card are issued in that order on its
    current stream (a copy between cards runs on the source card's
    stream, after a barrier with the destination's), so a later call's
    replay never writes memory that an earlier call's copy still reads,
    however many calls are in flight."""

    def __init__(self, mesh: DeviceMesh, renderer):
        cfg = renderer.config
        if cfg.packed_raster or cfg.two_pass_near_quads or cfg.temporal_hiz:
            raise ValueError("the views render runs the default binning's "
                             "single pass: a row band runs with neither the "
                             "packed raster nor an exact-occlusion pass")
        if cfg.height % (mesh.tp * 8):
            raise ValueError("height must split into 8-aligned bands")
        self.mesh = mesh
        self.band_h = cfg.height // mesh.tp
        self.renderer = renderer
        self._tables_of = renderer._tables_np
        self.tables = _color_tables(self._tables_of, mesh.distinct)
        self.shards = _Shards(self.step)
        self._replicas: dict = {}
        self._source = None      # (data_ptr, shape) the replicas copied

    def _check_tables(self) -> None:
        """After ``set_shading`` the renderer holds other colour tables:
        take them, and drop every graph (each captured the old ones)."""
        if self.renderer._tables_np is not self._tables_of:
            self._tables_of = self.renderer._tables_np
            self.tables = _color_tables(self._tables_of, self.mesh.distinct)
            self.shards.graphs.clear()

    def follow(self, pool: torch.Tensor, written) -> None:
        """Bring the replicas of ``pool`` (the engine's pool, on the mesh's
        first device) up to date: the rows ``written`` (slots), or every
        row where the replicas copied another tensor or ``written`` is
        None.  A replica keeps its memory (its graphs read it by address)
        unless the pool's shape changes."""
        src = (pool.data_ptr(), tuple(pool.shape))
        full = written is None or src != self._source
        idx = None
        for dev in self.mesh.distinct:
            if dev == pool.device:
                continue
            rep = self._replicas.get(dev)
            if rep is None or rep.shape != pool.shape:
                self._replicas[dev] = pool.to(dev)
            elif full:
                rep.copy_(pool)
            elif written:
                if idx is None:
                    idx = torch.tensor(sorted(written), dtype=torch.long)
                    rows = pool.index_select(0, idx.to(pool.device))
                rep.index_copy_(0, idx.to(dev), rows.to(dev))
        self._source = src

    def _pool_on(self, dev: torch.device, pool: torch.Tensor):
        return pool if dev == pool.device else self._replicas[dev]

    def _step_kw(self, cap: int) -> dict:
        kw = self.renderer._bucket_kw(cap)
        for k in ("color_tables", "near_quads", "packed_raster"):
            kw.pop(k)
        return kw

    def step(self, key, pool, frames):
        """Shard ``key`` = (gather cap, i, t)'s eager step on its device:
        each view of its dp row on its band.  Returns ([color [band_h, W]
        a view], [depth a view], the bands' counts i32[B / dp], stats
        i32[B / dp, 6])."""
        cap, _, t = key
        kw = self._step_kw(cap)
        outs = [views_band_frame(
            pool, frames[j], vcap=self.renderer.config.visible_chunks_cap,
            gather_cap=cap, band_y0=t * self.band_h, band_h=self.band_h,
            color_tables=self.tables[pool.device], **kw)
            for j in range(frames.shape[0])]
        stats = torch.stack([s for _, _, s in outs])
        return ([c for c, _, _ in outs], [d for _, d, _ in outs],
                stats[:, 1].clone(), stats)

    def _jobs(self, pool, frames, cap: int) -> list:
        """``_Shards``' jobs of a call: shard (i, t) keyed (cap, i, t),
        on its replica of the pool, with its dp row's views."""
        b = frames.shape[0]
        dp, tp = self.mesh
        if b % dp:
            raise ValueError(f"a batch of {b} views over dp = {dp}")
        per = b // dp
        return [((cap, i, t), self.mesh.devices[i, t],
                 [self._pool_on(self.mesh.devices[i, t], pool)],
                 [frames[i * per:(i + 1) * per]])
                for i in range(dp) for t in range(tp)]

    def reduce(self, shards: dict) -> None:
        """``psum(count, "tp") // tp`` of each view's band counts, as
        ``ShardedRender.reduce``."""
        _reduce_rows(self.mesh, shards)

    def gather(self, shards: dict) -> tuple:
        """The shards' outputs copied into fresh tensors on the mesh's
        first device: color i32[B, H, W], depth f32[B, H, W], stats
        i32[B, 6] (band 0's, with stats[1] the reduced count and stats[2]
        and stats[3] summed over the bands) and the reduced count as each
        tp card holds it, i32[B, tp]."""
        per = len(shards[0, 0][0])
        cfg = self.renderer.config
        color, depth = _stack_bands(self.mesh, shards, cfg.height, cfg.width)
        dev, b, tp = color.device, color.shape[0], self.mesh.tp
        band = torch.empty((tp, b, 6), dtype=torch.int32, device=dev)
        reduced = torch.empty((tp, b), dtype=torch.int32, device=dev)
        for (i, t), (_, _, n, st) in shards.items():
            band[t, i * per:(i + 1) * per].copy_(st)
            reduced[t, i * per:(i + 1) * per].copy_(n)
        stats = band[0].clone()
        stats[:, 1] = reduced[0]
        stats[:, 2:4] = band[:, :, 2:4].sum(0)
        return color, depth, stats, reduced.T.contiguous()

    def __call__(self, pool, written, frames, cap: int) -> tuple:
        """The views ``frames`` (``Renderer.pack_views``: on the card a
        slot of the renderer's pinned ring) at gather cap ``cap`` on
        ``pool`` with its rows ``written`` since the last call
        (``follow``): ``gather``'s outputs."""
        self._check_tables()
        with prof.VIEWS_LOAD:
            self.follow(pool, written)
            ready = self.shards.load(self._jobs(pool, frames, cap))
            self.renderer.copied(frames, self.mesh.distinct)
        with prof.VIEWS_REPLAY:
            shards = {k[1:]: out
                      for k, out in self.shards.replay(ready).items()}
        with prof.VIEWS_REDUCE:
            self.reduce(shards)
        with prof.VIEWS_GATHER:
            return self.gather(shards)

    def warm(self, pool, frames) -> None:
        """Every one-time cost, in a fixed order: the replicas (the peer
        copies from the first card), each dp row's all-reduce (its NCCL
        communicator), then each gather bucket's graph on every shard,
        the buckets in the renderer's order, on ``frames`` (a batch of the
        size the calls will bring)."""
        self.follow(pool, None)
        for row in self.mesh.devices:
            all_reduce_sum([torch.zeros(1, dtype=torch.int32, device=d)
                            for d in row])
        for cap in self.renderer.gather_buckets:
            self(pool, (), frames, cap)
        for d in self.mesh.distinct:
            if d.type == "cuda":
                torch.cuda.synchronize(d)


class ShardedRenderDP:
    """The camera batch over a 1-D mesh (``make_sharded_render_dp``).
    Calling it runs ``frames`` and ``gather``; ``step`` is a device's
    eager step."""

    def __init__(self, mesh: DeviceMesh, *, width: int, height: int,
                 render_cap: int, tile_k_cap: int, color_tables):
        self.devices = mesh.flat
        self.tables = _color_tables(color_tables, mesh.distinct)
        tile_h, tile_w = pick_tile(height, width)
        self.kw = dict(width=width, height=height, tile_h=tile_h,
                       tile_w=tile_w, render_cap=render_cap,
                       backface_culling=True, tile_k_cap=tile_k_cap)
        self.shards = _Shards(self.step)

    def step(self, key, quads, quad_world, n_quads, view_proj, cam_pos):
        """Device ``key``'s eager step: [(color, depth, stats) a camera]."""
        tables = self.tables[quads.device]
        return [render_step(quads[j], quad_world[j], n_quads[j],
                            view_proj[j], cam_pos[j], color_tables=tables,
                            **self.kw)
                for j in range(quads.shape[0])]

    def frames(self, quads, quad_world, n_quads, view_proj,
               cam_pos) -> list:
        """Each device's frames on it, the devices at once: [(color, depth,
        stats) a camera] a device, device k rendering cameras k * B / n ..
        (k + 1) * B / n - 1."""
        b, n = quads.shape[0], len(self.devices)
        if b % n:
            raise ValueError(f"a batch of {b} cameras over {n} devices")
        per = b // n
        args = (quads, quad_world, n_quads, view_proj, cam_pos)
        out = self.shards.run([
            (k, dev, [], [x[k * per:(k + 1) * per] for x in args])
            for k, dev in enumerate(self.devices)])
        return [out[k] for k in range(n)]

    def gather(self, shards: list) -> tuple:
        """The frames on the mesh's first device: color i32[B, H, W], depth
        f32[B, H, W] and stats i32[B, 6]."""
        frames = [f for s in shards for f in s]
        outs = tuple(torch.empty((len(frames), *x.shape), dtype=x.dtype,
                                 device=self.devices[0])
                     for x in frames[0])
        for b, frame in enumerate(frames):
            for out, x in zip(outs, frame):
                out[b].copy_(x)
        return outs

    def __call__(self, *args) -> tuple:
        return self.gather(self.frames(*args))


def make_sharded_render_dp(mesh_or_n: DeviceMesh | int | None = None, *,
                           width: int, height: int, render_cap: int = 4096,
                           tile_k_cap: int = 8192, color_tables=None):
    """The camera batch, each camera's full frame by the production step
    (the reference's 1-D dp mesh over every device, one camera a card).
    ``mesh_or_n``: a ``DeviceMesh`` (its devices in mesh order), or a
    count of CUDA cards for ``make_mesh`` (by default all of them).
    Returns (fn, n): ``fn(quads i32[B, GQ], quad_world f32[B, 3, GQ],
    n_quads i32[B], view_proj f32[B, 4, 4], cam_pos f32[B, 3])``, B a
    multiple of the n devices, gives on the first device color
    i32[B, H, W], depth f32[B, H, W] and stats i32[B, 6].  On cards each
    device's step is replayed from its CUDA graph, as
    ``make_sharded_render``'s."""
    mesh = (mesh_or_n if isinstance(mesh_or_n, DeviceMesh)
            else make_mesh(mesh_or_n))
    fn = ShardedRenderDP(mesh, width=width, height=height,
                         render_cap=render_cap, tile_k_cap=tile_k_cap,
                         color_tables=color_tables)
    return fn, len(fn.devices)
