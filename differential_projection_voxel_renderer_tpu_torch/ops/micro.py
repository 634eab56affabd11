"""Kernels M1 and M2: the launch-floor probes (csrc/micro.cu).

Counterparts of the Pallas kernels of the TPU cost probes
``benches/micro_fixed.py``, ``micro_fixed2.py`` and ``micro_fixed3.py``,
which the port's ``benches`` package drives:

- ``fill_tiles`` (M1) writes a constant frame, colour SKY + x_t and depth
  +inf, tile by tile as a ``FillLayout`` lays it out;
- ``blocked_copy`` (M2) writes ``in0 * mul + add`` (plus x where asked)
  for each output over int32 [rows, 128], block by block.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version (``fill_tiles_plain``, ``blocked_copy_plain``) for CPU
tensors; on a CUDA tensor it never falls back.  Every operand is checked
and passed as a pointer argument of its own, as K1's wrapper passes its
operands, so a call with more operands costs the host what such a call
costs.  Integer sums wrap, as int32 sums do in the reference.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import cached_property, lru_cache

import torch

from .raster import SKY_I32

# fill flags (csrc/micro.cu)
DEPTH = 1 << 0           # a depth output
DEPTH_ADD_X = 1 << 1     # depth = +inf + x_t, else +inf
MAP_ORDER = 1 << 2       # block b writes tile order[b]
MAP_CONST = 1 << 3       # every block writes tile 0
X_FROM_META = 1 << 4     # x_t = counts[b * tps] + starts[b * tps]
X_PLUS_SCRATCH = 1 << 5  # x_t += shared scratch[b], zero-filled first
X_PLUS_REC = 1 << 6      # x_t += recs[0, bidx[b] * BLOCK_Q]
TILE_GEO = 1 << 7        # stage a tile's first record block if count > 0
META_COPY = 1 << 8       # block 0 copies the metadata to shared memory
STAGE_TILE = 1 << 9      # build the tile in shared memory, then store

REC_ROWS = 24
BLOCK_Q = 256
N_EXTRA = 5         # operands a fill passes and never reads
MAX_IO = 8          # inputs, and outputs, a copy takes
SMEM_MAX = 232448   # shared memory one block can have on the H100

# launches of the CUDA kernels M1 and M2 (not of their plain versions)
launches_fill = 0
launches_copy = 0


@dataclass(frozen=True)
class FillLayout:
    """How M1 lays out a fill.

    The output (``out_shape``, 1-D or 2-D) is seen as a ``view`` frame of
    [tile_h, tile_w] tiles, ``steps_x`` to a row.  ``grid`` is (y, x)
    blocks; block b = y * grid[1] + x writes tile b in row-major order
    (``MAP_ORDER``: tile order[b]; ``MAP_CONST``: tile 0).  ``tps`` is the
    number of 128-wide tiles a block covers (the metadata index of
    ``X_FROM_META`` and ``TILE_GEO``).  The block's shared memory is
    ``smem_bytes`` in all; ``smem_a`` and ``smem_b`` are the words of its
    first and third arrays (the metadata copy holds starts, counts
    [smem_a] and rows, zmin [smem_b]; ``X_PLUS_SCRATCH`` reads the first),
    ``stage_off`` the word offset of the record stage."""

    out_shape: tuple
    tile_h: int
    tile_w: int
    grid: tuple
    flags: int = DEPTH
    tps: int = 1
    smem_bytes: int = 0
    smem_a: int = 0
    smem_b: int = 0
    stage_off: int = 0

    def __post_init__(self):
        rows, cols = self.view
        need = 0
        if self.flags & STAGE_TILE:
            need = 8 * self.tile_h * self.tile_w
        if self.flags & TILE_GEO:
            need = max(need, 4 * (self.stage_off
                                  + REC_ROWS * 2 * self.tps * BLOCK_Q))
        if self.flags & META_COPY:
            need = max(need, 8 * (self.smem_a + self.smem_b))
        if self.flags & X_PLUS_SCRATCH:
            need = max(need, 4 * self.smem_a)
        if (cols % self.tile_w or self.tile_w % 4 or rows < self.tile_h
                or not need <= self.smem_bytes <= SMEM_MAX):
            raise ValueError(f"bad fill layout {self}")

    @property
    def view(self) -> tuple[int, int]:
        if len(self.out_shape) == 2:
            return tuple(self.out_shape)
        return self.out_shape[0] // self.tile_w, self.tile_w

    @property
    def steps_x(self) -> int:
        return self.view[1] // self.tile_w

    @property
    def steps(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def rows_written(self) -> int:
        """Rows of ``view`` the blocks write (all unless the tiles stop
        short of the frame; ``MAP_ORDER`` is taken as a permutation)."""
        if self.flags & MAP_CONST:
            return self.tile_h
        tile_rows = -(-self.steps // self.steps_x)
        return min(self.view[0], tile_rows * self.tile_h)

    @property
    def n_tiles(self) -> int:
        """The frame's 128-wide tiles (the metadata ``TILE_GEO`` reads)."""
        return self.view[0] // self.tile_h * self.steps_x * self.tps

    @cached_property
    def c_params(self) -> ctypes.Array:
        """The kernel's host parameters (csrc/micro.cu FillParams)."""
        vals = (*self.view, self.tile_h, self.tile_w, *self.grid,
                self.steps_x, self.tps, self.flags, self.smem_a, self.smem_b,
                self.stage_off, self.smem_bytes)
        return (ctypes.c_int * len(vals))(*vals)


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values as int32, modulo 2**32."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _check(t, name, dev, dtype=None, numel=0) -> int:
    """The pointer of a checked operand."""
    if t.device != dev or not t.is_contiguous() or (
            dtype is not None and t.dtype != dtype):
        raise ValueError(f"{name} must be a contiguous "
                         f"{dtype or 'tensor'} on {dev}")
    if t.numel() < numel:
        raise ValueError(f"{name} holds {t.numel()} values, needs {numel}")
    return t.data_ptr()


def _device(*tensors) -> torch.device:
    for t in tensors:
        if t is not None:
            return t.device
    raise ValueError("a kernel call needs an operand on its device")


def fill_tiles_plain(layout: FillLayout, *, x=None, order=None, starts=None,
                     counts=None, meta_rows=None, meta_zmin=None, recs=None,
                     bidx=None, extra=()):
    """Plain PyTorch version of M1 with its signature and outputs."""
    dev = _device(x, order, starts, counts, meta_rows, meta_zmin, recs,
                  bidx, *extra)
    lay = layout
    rows, cols = lay.view
    b = torch.arange(lay.steps, device=dev)
    if lay.flags & X_FROM_META:
        xt = counts[b * lay.tps].long() + starts[b * lay.tps].long()
    elif x is not None:
        xt = x.reshape(-1)[:1].long().expand(lay.steps)
    else:
        xt = torch.zeros(lay.steps, dtype=torch.long, device=dev)
    if lay.flags & X_PLUS_REC:
        xt = xt + recs[0, bidx[:lay.steps].long() * BLOCK_Q].long()
    # X_PLUS_SCRATCH adds the zero-filled scratch: nothing
    xt = _wrap_i32(xt)
    colour = _wrap_i32(SKY_I32 + xt.long())
    depth = torch.full((lay.steps,), float("inf"), dtype=torch.float32,
                       device=dev)
    if lay.flags & DEPTH_ADD_X:
        depth = depth + xt.float()
    if lay.flags & MAP_CONST:
        tile = torch.zeros_like(b)
    elif lay.flags & MAP_ORDER:
        tile = order[:lay.steps].long()
    else:
        tile = b
    ty, tx = tile // lay.steps_x, tile % lay.steps_x
    ok = (tile >= 0) & ((ty + 1) * lay.tile_h <= rows)
    r = (ty[ok, None] * lay.tile_h
         + torch.arange(lay.tile_h, device=dev))[:, :, None]
    c = (tx[ok, None] * lay.tile_w
         + torch.arange(lay.tile_w, device=dev))[:, None, :]
    shape = (int(ok.sum()), lay.tile_h, lay.tile_w)
    outs = [(torch.int32, colour)]
    if lay.flags & DEPTH:
        outs.append((torch.float32, depth))
    res = []
    for dtype, vals in outs:
        out = torch.empty((rows, cols), dtype=dtype, device=dev)
        out[r, c] = vals[ok, None, None].expand(shape)
        res.append(out.reshape(lay.out_shape))
    return tuple(res)


def fill_tiles(layout: FillLayout, *, x=None, order=None, starts=None,
               counts=None, meta_rows=None, meta_zmin=None, recs=None,
               bidx=None, extra=()):
    """M1: the constant frame of ``layout``: colour (int32) SKY + x_t and,
    with ``DEPTH``, depth (float32) +inf, or +inf + x_t with
    ``DEPTH_ADD_X``, on every tile a block writes; other elements are left
    unwritten, as on the TPU.

    Operands, int32 unless said: ``x`` (x_t = x[0]), ``order`` [steps]
    (``MAP_ORDER``; a permutation of the tiles), ``starts``/``counts``
    (``X_FROM_META``, ``TILE_GEO``, ``META_COPY``), ``meta_rows`` and
    float32 ``meta_zmin`` [smem_b] (``META_COPY``), ``recs`` [24, cap]
    (``TILE_GEO``, ``X_PLUS_REC``), ``bidx`` [steps] (``X_PLUS_REC``; each
    must index a 256-column block of ``recs``), and up to five ``extra``
    operands of any type that the call passes and never reads.  Returns
    (colour,) or (colour, depth), each of ``layout.out_shape``."""
    ops = dict(x=x, order=order, starts=starts, counts=counts,
               meta_rows=meta_rows, meta_zmin=meta_zmin, recs=recs, bidx=bidx)
    dev = _device(*ops.values(), *extra)
    if dev.type != "cuda":
        return fill_tiles_plain(layout, extra=extra, **ops)
    global launches_fill
    from .. import _build

    lay, f = layout, layout.flags
    meta = max(lay.steps * lay.tps if f & X_FROM_META else 0,
               lay.n_tiles if f & TILE_GEO else 0,
               lay.smem_a if f & META_COPY else 0)
    need = dict(x=1 if x is not None else 0,
                order=lay.steps if f & MAP_ORDER else 0,
                starts=meta, counts=meta,
                meta_rows=lay.smem_b if f & META_COPY else 0,
                meta_zmin=lay.smem_b if f & META_COPY else 0,
                recs=BLOCK_Q if f & (TILE_GEO | X_PLUS_REC) else 0,
                bidx=lay.steps if f & X_PLUS_REC else 0)
    ptrs = []
    for name, t in ops.items():
        if t is None:
            if need[name]:
                raise ValueError(f"fill_tiles: layout needs {name}")
            ptrs.append(None)
        else:
            dtype = torch.float32 if name == "meta_zmin" else torch.int32
            ptrs.append(_check(t, name, dev, dtype, need[name]))
    if len(extra) > N_EXTRA:
        raise ValueError(f"fill_tiles passes at most {N_EXTRA} extra "
                         f"operands")
    ptrs += [_check(t, "extra", dev) for t in extra]
    ptrs += [None] * (N_EXTRA - len(extra))
    if recs is not None and (recs.dim() != 2 or recs.shape[0] != REC_ROWS):
        raise ValueError("recs must be int32 [24, cap]")
    rec_cap = recs.shape[1] if recs is not None else 0
    colour = torch.empty(lay.out_shape, dtype=torch.int32, device=dev)
    outs = (colour,)
    if f & DEPTH:
        outs += (torch.empty(lay.out_shape, dtype=torch.float32,
                             device=dev),)
    err = _build.lib().dpvr_fill_tiles(
        colour.data_ptr(), outs[1].data_ptr() if f & DEPTH else None,
        *ptrs, rec_cap, lay.c_params,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fill_tiles")
    launches_fill += 1
    return outs


@lru_cache(maxsize=256)
def _copy_params(rows, block_rows, n_in, pairs) -> ctypes.Array:
    """M2's host parameters (csrc/micro.cu CopyParams), made once for each
    form."""
    pad = MAX_IO - len(pairs)
    vals = (rows, block_rows, n_in, len(pairs),
            sum(1 << k for k, p in enumerate(pairs) if p[2]),
            *(p[0] for p in pairs), *(1,) * pad,
            *(p[1] for p in pairs), *(0,) * pad)
    return (ctypes.c_int * len(vals))(*vals)


def blocked_copy_plain(inputs, x, pairs, *, block_rows: int = 64, out=None):
    """Plain PyTorch version of M2 with its signature and outputs."""
    in0 = inputs[0].long()
    xv = x.reshape(-1)[:1].long()
    vals = [_wrap_i32(in0 * mul + add + (xv if adds_x else 0))
            for mul, add, adds_x in pairs]
    if out is None:
        return tuple(vals)
    res = []
    for o, v in zip(out, vals):
        if o is None:
            res.append(v)
        else:
            res.append(o.copy_(v))
    return tuple(res)


def blocked_copy(inputs, x, pairs, *, block_rows: int = 64, out=None):
    """M2: for each (mul, add, adds_x) of ``pairs``, an int32 output
    ``inputs[0] * mul + add``, plus x[0] where ``adds_x``, over int32
    [rows, 128] in [block_rows, 128] blocks (one block a grid step, as on
    the TPU).  The other inputs are operands the call passes and never
    reads.  ``out`` may give a tensor for each output (None: a new one); an
    output may be ``inputs[0]`` itself, the in-place form of the TPU's
    ``input_output_aliases``.  At most eight inputs and eight outputs.
    Returns the outputs."""
    in0 = inputs[0]
    if in0.device.type != "cuda":
        return blocked_copy_plain(inputs, x, pairs, block_rows=block_rows,
                                  out=out)
    global launches_copy
    from .. import _build

    dev = in0.device
    pairs = tuple((int(m), int(a), bool(ax)) for m, a, ax in pairs)
    if not (1 <= len(inputs) <= MAX_IO and 1 <= len(pairs) <= MAX_IO):
        raise ValueError("blocked_copy takes 1-8 inputs and 1-8 outputs")
    if (in0.dim() != 2 or in0.shape[1] != 128
            or in0.shape[0] % block_rows):
        raise ValueError(f"inputs[0] must be int32 [rows, 128], rows a "
                         f"multiple of {block_rows}")
    in_ptrs = [_check(t, "input", dev, torch.int32) for t in inputs]
    x_ptr = _check(x, "x", dev, torch.int32, 1)
    outs = list(out) if out is not None else [None] * len(pairs)
    if len(outs) != len(pairs):
        raise ValueError("out must give one entry for each output")
    for k, o in enumerate(outs):
        if o is None:
            outs[k] = torch.empty_like(in0)
        elif o.shape != in0.shape:
            raise ValueError("an output must have the input's shape")
    out_ptrs = [_check(o, "output", dev, torch.int32) for o in outs]
    pad = MAX_IO - len(pairs)
    err = _build.lib().dpvr_blocked_copy(
        *in_ptrs, *(None,) * (MAX_IO - len(inputs)), *out_ptrs,
        *(None,) * pad, x_ptr,
        _copy_params(in0.shape[0], block_rows, len(inputs), pairs),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "blocked_copy")
    launches_copy += 1
    return tuple(outs)
