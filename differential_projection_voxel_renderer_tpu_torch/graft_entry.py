"""Graft entry points of the port (counterpart of ``__graft_entry__.py``).

- ``entry()``             -> (forward render step, example tensors)
- ``dryrun_multichip(n)`` -> the (dp, tp) layout of ``make_mesh(n)`` run
                             through the sharded entry points, its n
                             entries laid round robin over the cards there
                             are

Nothing runs at import.  Both run on the card unless given
``device="cpu"``.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from .meshing.greedy import mesh_chunk
from .models.camera import Camera
from .models.chunk import Chunk
from .ops.projection import as_quad_words, color_table_tensors
from .ops.shading import build_quad_color_tables
from .ops.texture import TextureAtlas
from .parallel.sharded_render import (
    make_mesh,
    make_sharded_render,
    make_sharded_render_dp,
)
from .rendering.pipeline import (
    build_gather_indices,
    render_step,
    resolve_device,
)
from .utils.config import SKY_COLOR

SKY_I32 = int(np.uint32(SKY_COLOR).astype(np.int32))


def _example_scene(pool_slots=64, qcap=1024, n_chunks=9):
    """Small deterministic scene: a 3x3 patch of terrain chunks.  Returns
    (pool u32[S, Q], counts i32[S], positions i32[S, 3], slots used,
    camera)."""
    pool = np.zeros((pool_slots, qcap), np.uint32)
    counts = np.zeros(pool_slots, np.int32)
    positions = np.zeros((pool_slots, 3), np.int32)
    coords = [(x, 0, z) for x in (-1, 0, 1) for z in (-1, 0, 1)][:n_chunks]
    chunks = [Chunk.generate_terrain(pos) for pos in coords]
    slot = 0
    for c in chunks:
        q = mesh_chunk(c, chunks)
        if q is None:
            continue
        n = min(len(q), qcap)
        pool[slot, :n] = q[:n]
        counts[slot] = n
        positions[slot] = c.position
        slot += 1
    cam = Camera(np.array([10.0, 60.0, 90.0], np.float32), 16.0 / 9.0)
    cam.look_at(np.array([0.0, 0.0, 0.0], np.float32))
    return pool, counts, positions, slot, cam


def _tensors(device, *arrays):
    """numpy arrays -> tensors on ``device`` (uint32 as int32 bits)."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        t = (as_quad_words(a) if a.dtype == np.uint32
             else torch.from_numpy(np.ascontiguousarray(a)))
        out.append(t.to(device))
    return out


def entry(device="cuda", *, width: int = 1280, height: int = 720):
    """The flagship forward step (1280x720, textured and shaded, 16x128
    tiles, gather cap 16384, render cap 8192, item cap 2048) as
    ``fn(*args) -> (color, depth, stats)``, and its example tensors on
    ``device``: the 3x3 terrain scene's stream, gathered on the host (the
    ``prepare_uploads`` gather), its chunk origins, length and camera.
    ``width``/``height`` override the frame size."""
    dev = resolve_device(device)
    pool, counts, positions, n_slots, cam = _example_scene()
    tables = build_quad_color_tables(TextureAtlas().kernel_tables())
    fn = functools.partial(
        render_step, color_tables=color_table_tensors(tables, dev),
        width=width, height=height, tile_h=16, tile_w=128, render_cap=8192,
        backface_culling=True, tile_k_cap=2048)
    visible = np.zeros(64, np.int32)
    visible[:n_slots] = np.arange(n_slots)
    counts_sel = np.zeros(64, np.int32)
    counts_sel[:n_slots] = counts[:n_slots]
    positions_sel = np.zeros((64, 3), np.int32)
    positions_sel[:n_slots] = positions[:n_slots]
    slot_of, within, quad_world, total = build_gather_indices(
        counts_sel, visible, positions_sel, 16384)
    args = _tensors(dev, pool[slot_of, within], quad_world,
                    np.int32(total),
                    cam.view_projection_matrix().astype(np.float32),
                    cam.position.astype(np.float32))
    return fn, tuple(args)


def dryrun_multichip(n_devices: int, device="cuda"):
    """Run the (dp, tp) layout of ``make_mesh(n_devices)`` at the
    reference's dryrun sizes, and check it; returns the mesh.

    The reference builds an n-device virtual CPU mesh in a child process
    and shards the step over it.  The port lays the n entries over the
    cards there are, round robin (entry k on ``cuda:(k % count)``, through
    ``make_mesh``'s explicit ``devices=``), so that n = 4 on four cards
    takes four distinct cards and n = 8 two shards a card; with
    ``device="cpu"`` every entry is the CPU.  It logs the layout to
    standard error.

    1. ``make_sharded_render``: 128-wide frames, a camera per dp shard,
       gather cap 1024, render cap 512, on a 4-chunk scene.  The
       reference's checks (shapes, a non-zero survivor count, non-sky
       pixels), and one more: each camera's stacked bands equal the single
       full-frame ``render_step`` of the same stream bit for bit.
    2. ``make_sharded_render_dp``: the same camera on each of
       ``n_devices`` entries of the batch, 128x64; every entry must be
       bit-identical, and not all sky."""
    resolve_device(device)
    if torch.device(device).type == "cuda":
        count = torch.cuda.device_count()
        devices = [f"cuda:{k % count}" for k in range(n_devices)]
    else:
        devices = [device] * n_devices
    mesh = make_mesh(n_devices, devices=devices)
    dp, tp = mesh
    dev = mesh.devices[0, 0]
    print(f"dryrun_multichip({n_devices}): (dp, tp) = ({dp}, {tp}) over "
          f"{', '.join(map(str, mesh.flat))}", file=sys.stderr, flush=True)
    pool, counts, positions, n_slots, cam = _example_scene(
        pool_slots=16, qcap=512, n_chunks=4)
    width = 128
    height = 8 * tp * max(1, 64 // (8 * tp))
    step = make_sharded_render(mesh, width=width, height=height,
                               gather_cap=1024, render_cap=512)
    b = dp  # one camera per dp shard
    visible = np.zeros((b, 16), np.int32)
    visible[:, :n_slots] = np.arange(n_slots)[None, :]
    vp = np.repeat(cam.view_projection_matrix()[None], b, axis=0)
    cams = np.repeat(cam.position[None], b, axis=0)
    color, depth, count = step(*_tensors(
        dev, pool, counts, positions, visible,
        np.full(b, n_slots, np.int32), vp.astype(np.float32),
        cams.astype(np.float32)))
    assert color.shape == (b, height, width)
    assert depth.shape == (b, height, width)
    assert int(count[0]) > 0, "no quads survived culling"
    assert int((color != SKY_I32).sum()) > 0, "nothing rendered"
    # the single-camera step on the same stream: the bands stacked must
    # equal its frame bit for bit
    slot_of, within, qw, total = build_gather_indices(
        counts[:n_slots], np.arange(n_slots), positions[:n_slots], 1024)
    one = _tensors(dev, pool[slot_of, within], qw, np.int32(total),
                   vp[0].astype(np.float32), cams[0].astype(np.float32))
    tables = color_table_tensors(
        build_quad_color_tables(TextureAtlas().kernel_tables()), dev)
    c1, d1, _ = render_step(*one, color_tables=tables, width=width,
                            height=height, tile_h=16, tile_w=128,
                            render_cap=512, backface_culling=True,
                            tile_k_cap=8192)
    for i in range(b):
        assert torch.equal(color[i], c1) and torch.equal(depth[i], d1), (
            f"camera {i}: the stacked {tp} bands differ from the single "
            f"render_step frame")

    # ---- mode 2: the camera batch, one full frame an entry
    gq = 1024
    stream = np.zeros((n_devices, gq), np.uint32)
    qw2 = np.zeros((n_devices, 3, gq), np.float32)
    k = 0
    for s in range(n_slots):
        c = min(int(counts[s]), gq - k)
        if c <= 0:
            break
        stream[:, k:k + c] = pool[s, :c][None]
        for a in range(3):
            qw2[:, a, k:k + c] = positions[s, a] * 32.0
        k += c
    fn2, _ = make_sharded_render_dp(
        mesh, width=128, height=64, render_cap=512, tile_k_cap=512)
    c2, d2, _st2 = fn2(*_tensors(
        dev, stream, qw2, np.full(n_devices, k, np.int32),
        np.repeat(cam.view_projection_matrix()[None], n_devices,
                  0).astype(np.float32),
        np.repeat(cam.position[None], n_devices, 0).astype(np.float32)))
    assert c2.shape == (n_devices, 64, 128)
    assert bool((c2 == c2[0]).all()), "DP shards diverged (color)"
    assert bool((d2 == d2[0]).all()), "DP shards diverged (depth)"
    assert int((c2[0] != SKY_I32).sum()) > 0, "mode-2 rendered nothing"
    return mesh


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", [tuple(o.shape) for o in out])
    dryrun_multichip(8)
    print("dryrun ok")
