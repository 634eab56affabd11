"""Device meshing: exposed-face bitplanes and the binary greedy merge, as
torch ops on the engine's device.

Counterpart of ``differential_projection_voxel_renderer_tpu/ops/
meshing_jax.py``, which is jnp throughout (no Pallas kernel), so this is
torch ops throughout; a Hopper kernel for the merge waits until its cost
shows in PERF.md.  Voxels go up once and packed quad rows come back in the
device pool, byte-identical to the host mesher (meshing/greedy.py),
emission order included:

- ``face_masks``: six shifted solidity compares and a bit-pack over the
  slice axis, batched over chunks;
- ``greedy_merge``: one merge step (the first set bit, its run, the rows
  that extend it, their bits cleared) runs in lockstep over every (chunk,
  face, slice, type) plane, ``max_steps`` times; a plane with more quads
  keeps its first ``max_steps`` in order and counts in ``overflow``;
- ``mesh_chunks_device``: planes in (face, slice, type) order, so each
  chunk's compacted stream is the host mesher's.

The 32-bit words are held in int64 (``torch.uint32`` has few operations,
and a right shift of int32 sign-extends bit 31); the quad rows that leave
``mesh_chunks_device`` are int32 with the reference's uint32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import CHUNK_SIZE

U32 = 0xFFFFFFFF


def solidity(blocks: torch.Tensor) -> torch.Tensor:
    """bool solidity from block codes (air is 0 only)."""
    return blocks > 0


def _shift_occ(solid, nb, f):
    """The neighbour voxel across face ``f`` of every voxel ([B, z, y, x];
    the neighbour chunk's plane ``nb[:, f]`` past the border)."""
    if f == 0:
        return torch.cat([solid[:, :, :, 1:], nb[:, 0][:, :, :, None]], 3)
    if f == 1:
        return torch.cat([nb[:, 1][:, :, :, None], solid[:, :, :, :-1]], 3)
    if f == 2:
        return torch.cat([solid[:, :, 1:, :], nb[:, 2][:, :, None, :]], 2)
    if f == 3:
        return torch.cat([nb[:, 3][:, :, None, :], solid[:, :, :-1, :]], 2)
    if f == 4:
        return torch.cat([solid[:, 1:], nb[:, 4][:, None]], 1)
    return torch.cat([nb[:, 5][:, None], solid[:, :-1]], 1)


def face_masks(blocks: torch.Tensor,
               neighbor_planes: torch.Tensor) -> torch.Tensor:
    """Batched exposed-face bitmasks: ``blocks`` u8[B, 32, 32, 32] indexed
    [z, y, x], ``neighbor_planes`` bool[B, 6, 32, 32] (the adjacent chunk's
    solidity layer per face, meshing/face_masks.py's orientation).
    Returns int64[B, 6, 4, 32, 32] per-(face, type) slice masks (slice,
    row, column bit), the reference's uint32 values."""
    solid = solidity(blocks)
    b = blocks.shape[0]
    bits = torch.ones(32, dtype=torch.int64, device=blocks.device) << \
        torch.arange(32, device=blocks.device)
    bits_z, bits_y = bits[:, None, None], bits[None, :, None]
    out = []
    for f in range(6):
        ex = solid & ~_shift_occ(solid, neighbor_planes, f)
        per_type = [torch.zeros((b, 32, 32), dtype=torch.int64,
                                device=blocks.device)]
        for t in range(1, 4):
            m = (ex & (blocks == t)).long()
            axis = f // 2
            if axis == 0:    # slice x, row y, column bit z
                per_type.append((m * bits_z).sum(1).transpose(1, 2))
            elif axis == 1:  # slice y, row x, column bit z
                per_type.append((m * bits_z).sum(1))
            else:            # slice z, row x, column bit y
                per_type.append((m * bits_y).sum(2))
        out.append(torch.stack(per_type, 1))
    return torch.stack(out, 1)


def _ctz32(x: torch.Tensor) -> torch.Tensor:
    """Trailing zeros of int64 ``x`` in [0, 2**32), 32 for 0: the exponent
    of the isolated lowest bit, exact in float64 for a power of two."""
    low = x & -x
    _, e = torch.frexp(low.double())
    return torch.where(x == 0, 32, e.long() - 1)


def greedy_merge(masks: torch.Tensor, *, max_steps: int = 64):
    """Lockstep greedy merge over every plane: ``masks`` int64[..., 32]
    (the last dim 32 rows, bits the columns).  Returns (quads
    int64[..., max_steps] packed row | col << 5 | (width - 1) << 10 |
    (height - 1) << 16, valid bool[..., max_steps], overflow bool[...]).
    Step k of a plane emits the quad the reference's sequential bit-scan
    merge emits k-th; consumed bits are cleared."""
    shape = masks.shape[:-1]
    data = masks.reshape(-1, 32).long()
    dev = data.device
    rows = torch.arange(32, device=dev)[None, :]
    quads, valid = [], []
    for _ in range(max_steps):
        nonzero = data != 0
        any_left = nonzero.any(1)
        row = torch.argmax(nonzero.to(torch.uint8), 1)  # the first nonzero
        rowbits = torch.gather(data, 1, row[:, None])[:, 0]
        col = _ctz32(rowbits)
        shifted = torch.where(col < 32, rowbits >> torch.clamp(col, max=31),
                              0)
        height = _ctz32(~shifted & U32)
        hmask = torch.where(height >= 32, U32,
                            (1 << torch.clamp(height, max=31)) - 1)
        mask = (hmask << torch.clamp(col, max=31)) & U32
        # the rows after ``row`` that hold the whole run: the prefix of
        # such rows extends the quad
        drow = torch.where(col[:, None] < 32,
                           data >> torch.clamp(col, max=31)[:, None], 0)
        ok = (drow & hmask[:, None]) == hmask[:, None]
        after = rows > row[:, None]
        broken = torch.cumsum((after & ~ok).to(torch.int32), 1)
        grabbed = after & ok & (broken == 0)
        width = 1 + grabbed.sum(1)
        clear = (grabbed | (rows == row[:, None])) & any_left[:, None]
        data = torch.where(clear, data & (~mask & U32)[:, None], data)
        quad = (row | (col << 5) | ((width - 1) << 10)
                | ((height - 1) << 16)) & U32
        quads.append(torch.where(any_left, quad, 0))
        valid.append(any_left)
    overflow = (data != 0).any(1).reshape(shape)
    return (torch.stack(quads, -1).reshape(shape + (max_steps,)),
            torch.stack(valid, -1).reshape(shape + (max_steps,)), overflow)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 bit pattern -> int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def mesh_chunks_device(blocks, neighbor_planes, *, max_steps: int = 64,
                       qcap: int = 4096):
    """Voxels u8[B, 32, 32, 32] and neighbour planes bool[B, 6, 32, 32] ->
    (quads i32[B, qcap] in quad_format's packing, counts i32[B], overflow
    i32[B]: quads past qcap plus planes past max_steps).  Each chunk's
    quads are the host mesher's, in its order."""
    b = blocks.shape[0]
    dev = blocks.device
    # (face, slice, type) plane order: the host mesher's loop nesting
    planes = face_masks(blocks, neighbor_planes).permute(0, 1, 3, 2, 4)
    quads, valid, overflow = greedy_merge(planes, max_steps=max_steps)
    face = torch.arange(6, device=dev)[None, :, None, None, None]
    slice_idx = torch.arange(32, device=dev)[None, None, :, None, None]
    btype = torch.arange(4, device=dev)[None, None, None, :, None]
    packed = quads | (btype << 22) | (slice_idx << 24) | (face << 29)
    flat_q = packed.reshape(b, -1)
    flat_v = valid.reshape(b, -1)
    # per-chunk order-preserving compaction: a batched search of the
    # cumulative valid count
    csum = torch.cumsum(flat_v.to(torch.int32), 1)
    counts = csum[:, -1]
    targets = torch.arange(1, qcap + 1, dtype=torch.int32, device=dev)
    src = torch.searchsorted(csum, targets.expand(b, qcap).contiguous())
    src = torch.clamp(src, max=flat_q.shape[1] - 1)
    in_range = targets[None, :] <= torch.clamp(counts, max=qcap)[:, None]
    out = torch.where(in_range, torch.gather(flat_q, 1, src), 0)
    q_overflow = (torch.clamp(counts - qcap, min=0)
                  + overflow.reshape(b, -1).sum(1))
    return (_to_i32(out), torch.clamp(counts, max=qcap),
            q_overflow.to(torch.int32))


# batch sizes of the bucketed front end (the reference's shape ladder; the
# port keeps it so that the caching allocator sees few shapes)
MESH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


def mesh_bucket_for(b: int) -> int:
    for m in MESH_BUCKETS:
        if b <= m:
            return m
    return MESH_BUCKETS[-1]


def mesh_chunks_meta(blocks, neighbor_planes, *, max_steps: int,
                     qcap: int):
    """Meshing plus the host metadata in one i32[B, 8] array (count |
    overflow | counts6), so the caller fetches that, not the rows (the
    reference's ``_mesh_chunks_jit``).  Returns (quads i32[B, qcap],
    meta)."""
    quads, counts, overflow = mesh_chunks_device(
        blocks, neighbor_planes, max_steps=max_steps, qcap=qcap)
    dirs = (quads >> 29) & 7
    in_count = (torch.arange(qcap, device=quads.device)[None, :]
                < counts[:, None])
    c6 = torch.stack([((dirs == d) & in_count).sum(1) for d in range(6)],
                     1).to(torch.int32)
    return quads, torch.cat([counts[:, None], overflow[:, None], c6], 1)


def mesh_chunks_device_bucketed(blocks: np.ndarray, planes: np.ndarray, *,
                                max_steps: int = 64, qcap: int = 4096,
                                device="cuda"):
    """The streaming and bulk front end: the batch (numpy) padded to the
    next MESH_BUCKETS size by repeating chunk 0 (duplicate chunks mesh to
    identical rows, so a duplicate-index pool scatter stays
    deterministic), meshed on ``device``.  Returns (quads i32[bucket,
    qcap] on the device, counts i32[b], overflow i32[b], c6 i32[b, 6],
    bucket), the host metadata from one device-to-host copy."""
    b = blocks.shape[0]
    if b < 1:
        raise ValueError("an empty meshing batch")
    bucket = mesh_bucket_for(b)
    if bucket != b:
        rep = np.broadcast_to(blocks[0], (bucket - b,) + blocks.shape[1:])
        blocks = np.concatenate([blocks, rep])
        repp = np.broadcast_to(planes[0], (bucket - b,) + planes.shape[1:])
        planes = np.concatenate([planes, repp])
    quads, meta = mesh_chunks_meta(
        torch.from_numpy(np.ascontiguousarray(blocks)).to(device),
        torch.from_numpy(np.ascontiguousarray(planes)).to(device),
        max_steps=max_steps, qcap=qcap)
    meta = meta.cpu().numpy()
    return (quads, meta[:b, 0].copy(), meta[:b, 1].copy(),
            meta[:b, 2:].copy(), bucket)


def neighbor_planes_from_batch(blocks_by_pos: dict, positions) -> np.ndarray:
    """Host helper: bool[B, 6, 32, 32] neighbour planes for a batch of
    chunk positions from a {pos: uint8[32, 32, 32]} dict (a missing
    neighbour is air)."""
    offs = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
            (0, 0, -1)]
    b = len(positions)
    planes = np.zeros((b, 6, CHUNK_SIZE, CHUNK_SIZE), dtype=bool)
    for i, pos in enumerate(positions):
        pos = tuple(int(c) for c in pos)
        for f, off in enumerate(offs):
            nb = blocks_by_pos.get((pos[0] + off[0], pos[1] + off[1],
                                    pos[2] + off[2]))
            if nb is None:
                continue
            s = nb > 0
            if f == 0:
                planes[i, f] = s[:, :, 0]
            elif f == 1:
                planes[i, f] = s[:, :, CHUNK_SIZE - 1]
            elif f == 2:
                planes[i, f] = s[:, 0, :]
            elif f == 3:
                planes[i, f] = s[:, CHUNK_SIZE - 1, :]
            elif f == 4:
                planes[i, f] = s[0, :, :]
            else:
                planes[i, f] = s[CHUNK_SIZE - 1, :, :]
    return planes
