"""The reference frame of a pose over a world: terrain, meshes, draw
list, expansion, stage A and raster, from the loaded chunk positions, the
pose and the chunks that the program held meshed (a chunk meshes against
the neighbours loaded at that moment, so which neighbours a mesh sees is
worked out from them: see ``Reference.frame``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import funnel, mesher, raster
from .constants import CHUNK_SIZE
from .shading import build_quad_color_tables
from .terrain import Terrain
from .texture import TextureAtlas


@dataclass
class RefFrame:
    positions: np.ndarray      # int64 [n, 3], the draw list
    masks: np.ndarray          # int32 [n, 6]
    meshes: list               # uint32 arrays, one a draw-list chunk
    gathered: int              # quads in the expanded stream
    rasterized: int            # quads that pass stage A
    color: np.ndarray          # int32 [R, W], the sampled rows
    depth: np.ndarray          # float64 [R, W]


class Reference:
    def __init__(self, config: dict, device, dtype=torch.float64):
        r = config["render"]
        self.width, self.height = int(r["width"]), int(r["height"])
        self.vd = int(config["world"]["view_distance"])
        self.vcap = int(r["visible_chunks_cap"])
        self.device, self.dtype = torch.device(device), dtype
        self.tables = build_quad_color_tables(
            TextureAtlas().kernel_tables(),
            enable_shading=bool(r["enable_shading"]),
            enable_textures=bool(r["enable_textures"]))
        self.terrain = Terrain()
        self._meshes: dict = {}

    def mesh(self, pos: tuple, present: tuple) -> np.ndarray:
        key = (pos, present)
        m = self._meshes.get(key)
        if m is None:
            nbs = [self.terrain.chunk((pos[0] + a, pos[1] + b, pos[2] + c))
                   if here else None
                   for (a, b, c), here in zip(mesher.NEIGHBOR_OFFSETS,
                                              present)]
            m = self._meshes[key] = mesher.mesh_chunk(
                self.terrain.chunk(pos), nbs)
        return m

    def frame(self, keys, pose, rows_first: int, rows_step: int, *,
              pooled=frozenset(), program=None) -> RefFrame:
        """``keys``: the loaded chunk positions in the world's table order;
        ``pooled``: the positions the program held meshed at the frame;
        ``program(p)``: the program's mesh of chunk ``p`` (uint32 words),
        or None.  A chunk meshes against the neighbours loaded when it is
        meshed, and a loaded, meshed chunk is meshed again whenever a
        neighbour of it is meshed, so a neighbour in ``pooled`` was loaded
        at the chunk's last meshing.  Of any other neighbour either state
        is sound: the faces of the chunk that look towards it follow the
        program's faces in that direction where they match one of the
        two, and otherwise whether the neighbour is loaded now."""
        keys = np.asarray(keys, np.int64).reshape(-1, 3)
        loaded = set(map(tuple, keys.tolist()))
        chosen: dict = {}

        def mesh_at(p):
            p = tuple(int(c) for c in p)
            if p not in chosen:
                chosen[p] = self._mesh_sound(p, pooled, loaded, program)
            return chosen[p]

        def has_quads(vis):
            return np.array([len(mesh_at(p)) > 0 for p in vis], bool)

        cam = funnel.camera_of(pose.position, pose.yaw, pose.pitch,
                               self.width, self.height)
        positions, masks = funnel.draw_list(
            keys, cam, has_quads, view_distance=self.vd, vcap=self.vcap)
        meshes = [mesh_at(p) for p in positions]
        words, origins = [], []
        for p, m, q in zip(positions, masks, meshes):
            keep = m[(q >> 29) & 7].astype(bool)
            words.append(q[keep])
            origins.append(np.repeat(p[None].astype(np.float64)
                                     * CHUNK_SIZE, int(keep.sum()), 0))
        words = np.concatenate(words) if words else np.zeros(0, np.uint32)
        origins = (np.concatenate(origins) if origins
                   else np.zeros((0, 3), np.float64))
        vp = cam.view_projection_matrix().astype(np.float64)
        dev = self.device
        s = raster.Stream(torch.from_numpy(words.astype(np.int64)).to(dev),
                          torch.from_numpy(origins).to(dev), vp,
                          np.asarray(cam.position, np.float64),
                          self.width, self.height, self.dtype)
        color, depth = raster.rasterize(s, self.tables, rows_first,
                                        rows_step)
        return RefFrame(positions, masks, meshes, len(words), s.n_visible,
                        color.cpu().numpy(), depth.cpu().numpy())

    def _mesh_sound(self, p: tuple, pooled, loaded, program) -> np.ndarray:
        """The mesh of chunk ``p`` under the neighbour rule of ``frame``."""
        nbs = [(p[0] + a, p[1] + b, p[2] + c)
               for a, b, c in mesher.NEIGHBOR_OFFSETS]
        certain = tuple(q in pooled for q in nbs)
        lo = self.mesh(p, certain)
        if all(certain):
            return lo
        hi = self.mesh(p, (True,) * 6)
        got = program(p) if program is not None else None
        parts = []
        for d, q in enumerate(nbs):
            a, b = face_of(lo, d), face_of(hi, d)
            if certain[d] or np.array_equal(a, b):
                parts.append(a)
                continue
            g = face_of(got, d) if got is not None else None
            if g is not None and np.array_equal(g, b):
                parts.append(b)
            elif g is not None and np.array_equal(g, a):
                parts.append(a)
            else:
                parts.append(b if q in loaded else a)
        return np.concatenate(parts)


def face_of(mesh: np.ndarray, d: int) -> np.ndarray:
    """The quads of ``mesh`` that face direction ``d``."""
    return mesh[((mesh >> 29) & 7) == d]
