"""Scenes shared by the port's CPU tests (tests/test_torch_*.py): the
reference fuzz chunk and the 3x3 terrain patch of ``__graft_entry__``,
flattened to a gather stream with the JAX package's host-side
``build_gather_indices``, and the same inputs as JAX arrays and as torch
tensors."""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import torch

from differential_projection_voxel_renderer_tpu.meshing.greedy import mesh_chunk
from differential_projection_voxel_renderer_tpu.models.camera import Camera
from differential_projection_voxel_renderer_tpu.ops.shading import (
    build_quad_color_tables,
)
from differential_projection_voxel_renderer_tpu.ops.texture import TextureAtlas
from differential_projection_voxel_renderer_tpu.rendering import parity
from differential_projection_voxel_renderer_tpu.rendering.pipeline import (
    build_gather_indices,
)
from differential_projection_voxel_renderer_tpu_torch.ops import (
    projection as TP,
)
from differential_projection_voxel_renderer_tpu_torch.rendering.parity import (
    SMALL_SCENES,
)

# The twins run thousands of small ops; with several test workers on one
# host, torch's intra-op thread pool oversubscribes the cores and every
# parallel region waits on descheduled threads (8x slower at 2 workers).
torch.set_num_threads(1)

TABLES = build_quad_color_tables(TextureAtlas().kernel_tables())

# name -> (width, height, gather cap, camera position, camera target): the
# sizes and cameras of the port's card scenes
SCENES = {"fuzz": SMALL_SCENES["fuzz 128x128"],
          "terrain": SMALL_SCENES["terrain 640x128"]}


def _pool(name):
    if name == "fuzz":
        quads = mesh_chunk(parity.fuzz_chunk())
        pool = np.zeros((1, 4096), np.uint32)
        pool[0, :len(quads)] = quads
        return pool, np.array([len(quads)]), np.zeros((1, 3), np.int32)
    from __graft_entry__ import _example_scene

    pool, counts, positions, n, _cam = _example_scene()
    return pool[:n], counts[:n], positions[:n]


def scene(name):
    """(stream u32[GC], quad_world f32[3, GC], total, view_proj, cam_pos,
    (width, height, gather_cap))."""
    w, h, gc, pos, tgt = SCENES[name]
    pool, counts, positions = _pool(name)
    slots = np.arange(len(counts), dtype=np.int32)
    slot_of, within, quad_world, total = build_gather_indices(
        counts, slots, positions, gc)
    cam = Camera(np.asarray(pos, np.float32), w / h)
    cam.look_at(np.asarray(tgt, np.float32))
    return (pool[slot_of, within], quad_world, total,
            cam.view_projection_matrix().astype(np.float32),
            cam.position.astype(np.float32), (w, h, gc))


def jax_args(sc):
    stream, qw, total, vp, cp, _ = sc
    return (jnp.asarray(stream), jnp.asarray(qw), jnp.asarray(total, jnp.int32),
            jnp.asarray(vp), jnp.asarray(cp))


def torch_args(sc, device="cpu"):
    stream, qw, total, vp, cp, _ = sc
    return tuple(t.to(device) for t in (
        TP.as_quad_words(stream), torch.from_numpy(qw),
        torch.tensor(total, dtype=torch.int32), torch.from_numpy(vp),
        torch.from_numpy(cp)))


def jax_step_kw(sc, render_cap):
    w, h, gc = sc[5]
    return dict(color_tables=TABLES, width=w, height=h, tile_h=16,
                tile_w=128, gather_cap=gc, render_cap=render_cap,
                span_mode=False, backface_culling=True, use_pallas=True,
                interpret=True, tile_k_cap=2 * gc)


def torch_step_kw(sc, render_cap, device="cpu"):
    w, h, gc = sc[5]
    return dict(color_tables=TP.color_table_tensors(TABLES, device),
                width=w, height=h, tile_h=16, tile_w=128,
                render_cap=render_cap, tile_k_cap=2 * gc)
