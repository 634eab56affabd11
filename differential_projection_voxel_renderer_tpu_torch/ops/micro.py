"""Kernels M1 and M2: the launch-floor probes (csrc/micro.cu).

Counterparts of the Pallas kernels of the TPU cost probes
``benches/micro_fixed.py``, ``micro_fixed2.py`` and ``micro_fixed3.py``,
which the port's ``benches`` package drives:

- ``fill_tiles`` (M1) writes a constant frame, colour SKY + x_t and depth
  +inf, tile by tile as a ``FillLayout`` lays it out;
- ``blocked_copy`` (M2) writes ``in0 * mul + add`` (plus x where asked)
  for each output over int32 [rows, 128].

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version (``fill_tiles_plain``, ``blocked_copy_plain``) for CPU
tensors; on a CUDA tensor it never falls back.  A call is lean, as K1's
is: its outputs are views of one new buffer (``fill_outputs``,
``copy_outputs``), the launch goes to the current stream's raw handle,
the host parameters are made once a form (``FillLayout.c_params``,
``_copy_params``), and each operand is checked by a few attribute reads.
Every operand is still passed as a pointer argument of its own, so a call
with more operands costs the host what such a call costs.  Integer sums
wrap, as int32 sums do in the reference.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import cached_property, lru_cache
from typing import NamedTuple

import torch

from .. import _build
from .raster import SKY_I32

# fill flags (csrc/micro.cu)
DEPTH = 1 << 0           # a depth output
DEPTH_ADD_X = 1 << 1     # depth = +inf + x_t, else +inf
MAP_ORDER = 1 << 2       # step b writes tile order[b]
MAP_CONST = 1 << 3       # every step writes tile 0
X_FROM_META = 1 << 4     # x_t = counts[b * tps] + starts[b * tps]
X_PLUS_SCRATCH = 1 << 5  # x_t += shared scratch[b], zero-filled first
X_PLUS_REC = 1 << 6      # x_t += recs[0, bidx[b] * BLOCK_Q]
STAGE_TILE = 1 << 7      # stage the block's vectors in shared memory

REC_ROWS = 24
BLOCK_Q = 256
N_EXTRA = 5         # operands a fill passes and never reads
MAX_IO = 8          # inputs, and outputs, a copy takes
FILL_THREADS = 256  # M1's threads a block, one 16-byte vector each
COPY_THREADS = 128  # M2's threads a block, one 16-byte vector of in0 each
_NULLS = (None,) * MAX_IO

# launches of the CUDA kernels M1 and M2 (not of their plain versions)
launches_fill = 0
launches_copy = 0


class FillPlan(NamedTuple):
    """M1's launch: thread g of ``blocks`` x ``threads`` writes vector
    g % n4 of step ``step0`` + g // n4 (the last ``threads`` may pass the
    ``steps`` x n4 vectors and store nothing); a block's dynamic shared
    memory is ``smem_bytes``, the staged vectors first (``STAGE_TILE``:
    16 bytes a thread and output) and ``scratch_words`` zero-filled words
    at word ``scratch_off`` (``X_PLUS_SCRATCH``: one a step the block
    spans)."""

    step0: int
    steps: int
    n4: int
    blocks: int
    threads: int
    smem_bytes: int
    scratch_off: int
    scratch_words: int


@dataclass(frozen=True)
class FillLayout:
    """How M1 lays out a fill.

    The output (``out_shape``, 1-D or 2-D) is seen as a ``view`` frame of
    [tile_h, tile_w] tiles, ``steps_x`` to a row, tile_w a multiple of 4
    (16-byte stores).  ``grid`` is the reference's (y, x) grid; its step
    b = y * grid[1] + x writes tile b in row-major order (``MAP_ORDER``:
    tile order[b]; ``MAP_CONST``: tile 0, which keeps the last step's
    value).  ``tps`` is the number of 128-wide tiles a step covers (the
    metadata index of ``X_FROM_META``).  The TPU variants' scratch, their
    metadata copy and their record stage decided no value and have no
    field here; the kernel reserves only the shared memory its blocks
    read (``plan``)."""

    out_shape: tuple
    tile_h: int
    tile_w: int
    grid: tuple
    flags: int = DEPTH
    tps: int = 1

    def __post_init__(self):
        rows, cols = self.view
        if cols % self.tile_w or self.tile_w % 4 or rows < self.tile_h:
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
        """Rows of ``view`` the steps write (all unless the tiles stop
        short of the frame; ``MAP_ORDER`` is taken as a permutation)."""
        if self.flags & MAP_CONST:
            return self.tile_h
        tile_rows = -(-self.steps // self.steps_x)
        return min(self.view[0], tile_rows * self.tile_h)

    @cached_property
    def plan(self) -> FillPlan:
        """M1's launch on the card (csrc/micro.cu fill_tiles_kernel)."""
        n4 = self.tile_h * self.tile_w // 4
        step0, steps = ((self.steps - 1, 1) if self.flags & MAP_CONST
                        else (0, self.steps))
        blocks = -(-steps * n4 // FILL_THREADS)
        staged = 0
        if self.flags & STAGE_TILE:
            staged = 16 * FILL_THREADS * (2 if self.flags & DEPTH else 1)
        words = 0
        if self.flags & X_PLUS_SCRATCH:  # the most steps a block spans
            last = steps * n4 - 1
            words = max(min(g + FILL_THREADS - 1, last) // n4 - g // n4 + 1
                        for g in range(0, blocks * FILL_THREADS,
                                       FILL_THREADS))
        return FillPlan(step0, steps, n4, blocks, FILL_THREADS,
                        staged + 4 * words, staged // 4, words)

    @cached_property
    def c_params(self) -> ctypes.Array:
        """The kernel's host parameters (csrc/micro.cu FillParams, then
        blocks, threads and shared memory)."""
        rows, cols = self.view
        p = self.plan
        vals = (rows, cols, self.tile_h, self.tile_w, rows // self.tile_h,
                self.steps_x, self.tps, self.flags, p.step0, p.n4,
                p.steps * p.n4, p.scratch_off, p.scratch_words, p.blocks,
                p.threads, p.smem_bytes)
        return (ctypes.c_int * len(vals))(*vals)

    @cached_property
    def reads(self) -> tuple:
        """(name, dtype, values the kernel reads) of each named operand of
        ``fill_tiles``, in order: x is optional and read where given; the
        others are read, and needed, where a flag reads them (values > 0,
        ``needs``)."""
        f, steps = self.flags, self.steps
        meta = steps * self.tps if f & X_FROM_META else 0
        i32 = torch.int32
        return (("x", i32, 1), ("order", i32, steps if f & MAP_ORDER else 0),
                ("starts", i32, meta), ("counts", i32, meta),
                ("meta_rows", i32, 0), ("meta_zmin", torch.float32, 0),
                ("recs", i32, BLOCK_Q if f & X_PLUS_REC else 0),
                ("bidx", i32, steps if f & X_PLUS_REC else 0))

    @cached_property
    def needs(self) -> tuple:
        """Indices in ``reads`` of the operands the layout needs."""
        return tuple(i for i, (_, _, n) in enumerate(self.reads)
                     if n and i)


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values as int32, modulo 2**32."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _ptr(t, dev: int, dtype, name: str, numel: int = 0) -> int:
    """The pointer of a checked operand: contiguous, on card ``dev``, of
    ``dtype`` (any where None), with at least ``numel`` values."""
    if (t.get_device() != dev or not t.is_contiguous()
            or (dtype is not None and t.dtype is not dtype)):
        raise ValueError(f"{name} must be a contiguous "
                         f"{dtype or 'tensor'} on cuda:{dev}")
    if numel and t.numel() < numel:
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


def fill_outputs(layout: FillLayout, device) -> tuple:
    """M1's outputs for a call: (colour,) or, with ``DEPTH``, (colour,
    depth), int32 and float32 of ``layout.out_shape``, views of one new
    int32 buffer (the depth view 16-byte aligned: a frame's columns are a
    multiple of 4)."""
    if not layout.flags & DEPTH:
        return (torch.empty(layout.out_shape, dtype=torch.int32,
                            device=device),)
    colour, depth = torch.empty((2, *layout.out_shape), dtype=torch.int32,
                                device=device).unbind()
    return colour, depth.view(torch.float32)


def fill_tiles(layout: FillLayout, *, x=None, order=None, starts=None,
               counts=None, meta_rows=None, meta_zmin=None, recs=None,
               bidx=None, extra=()):
    """M1: the constant frame of ``layout``: colour (int32) SKY + x_t and,
    with ``DEPTH``, depth (float32) +inf, or +inf + x_t with
    ``DEPTH_ADD_X``, on every tile a step writes; other elements are left
    unwritten, as on the TPU.

    Operands, int32 unless said: ``x`` (x_t = x[0]), ``order`` [steps]
    (``MAP_ORDER``; a permutation of the tiles), ``starts``/``counts``
    (``X_FROM_META``), ``meta_rows`` and float32 ``meta_zmin`` (passed,
    never read), ``recs`` [24, cap] (``X_PLUS_REC``), ``bidx`` [steps]
    (``X_PLUS_REC``; each must index a 256-column block of ``recs``), and
    up to five ``extra`` operands of any type that the call passes and
    never reads; each named operand may be given where no flag reads it,
    as the TPU variants pass their metadata and records.  Returns
    (colour,) or (colour, depth), each of ``layout.out_shape``
    (``fill_outputs``)."""
    ops = (x, order, starts, counts, meta_rows, meta_zmin, recs, bidx)
    dev = x.device if x is not None else _device(*ops, *extra)
    if dev.type != "cuda":
        return fill_tiles_plain(layout, x=x, order=order, starts=starts,
                                counts=counts, meta_rows=meta_rows,
                                meta_zmin=meta_zmin, recs=recs, bidx=bidx,
                                extra=extra)
    global launches_fill
    idx = dev.index
    for i in layout.needs:
        if ops[i] is None:
            raise ValueError(f"fill_tiles: layout needs {layout.reads[i][0]}")
    ptrs = [None if t is None else _ptr(t, idx, dtype, name, numel)
            for t, (name, dtype, numel) in zip(ops, layout.reads)]
    if extra:
        if len(extra) > N_EXTRA:
            raise ValueError(f"fill_tiles passes at most {N_EXTRA} extra "
                             f"operands")
        ptrs += [_ptr(t, idx, None, "extra") for t in extra]
    if recs is not None and (recs.dim() != 2 or recs.shape[0] != REC_ROWS):
        raise ValueError("recs must be int32 [24, cap]")
    outs = fill_outputs(layout, dev)
    # the raw handle of the current stream, as K1's wrapper takes it
    err = _build.lib().dpvr_fill_tiles(
        outs[0].data_ptr(), outs[1].data_ptr() if len(outs) > 1 else None,
        *ptrs, *_NULLS[:N_EXTRA - len(extra)], layout.c_params,
        torch._C._cuda_getCurrentRawStream(idx))
    _build.check(err, "fill_tiles")
    launches_fill += 1
    return outs


def copy_grid(rows: int) -> tuple[int, int]:
    """M2's launch over int32 [rows, 128]: (blocks, threads); thread g =
    block * threads + thread reads vector g of in0 and writes vector g of
    each output, where g < rows * 32."""
    return -(-rows * 32 // COPY_THREADS), COPY_THREADS


@lru_cache(maxsize=256)
def _copy_params(rows, block_rows, n_in, pairs) -> ctypes.Array:
    """M2's host parameters (csrc/micro.cu CopyParams, in the order the C
    entry reads them), made once for each form; checks the form."""
    pairs = tuple((int(m), int(a), bool(ax)) for m, a, ax in pairs)
    if not (1 <= n_in <= MAX_IO and 1 <= len(pairs) <= MAX_IO):
        raise ValueError("blocked_copy takes 1-8 inputs and 1-8 outputs")
    if block_rows <= 0 or rows % block_rows:
        raise ValueError(f"inputs[0] must be int32 [rows, 128], rows a "
                         f"multiple of {block_rows}")
    pad = MAX_IO - len(pairs)
    vals = (rows, block_rows, n_in, len(pairs),
            sum(1 << k for k, p in enumerate(pairs) if p[2]),
            *copy_grid(rows),
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


def copy_outputs(in0, n_out: int, out=None) -> tuple:
    """M2's outputs for a call: the tensors ``out`` gives (each an int32
    [rows, 128] like ``in0`` on its device, ``in0`` itself allowed), and
    for the k outputs it leaves None (all of them without ``out``) views
    of one new int32 buffer [k, rows, 128] (the buffer itself where k is
    1)."""
    if out is None:
        if n_out == 1:
            return (torch.empty(in0.shape, dtype=torch.int32,
                                device=in0.device),)
        return torch.empty((n_out, *in0.shape), dtype=torch.int32,
                           device=in0.device).unbind()
    if len(out) != n_out:
        raise ValueError("out must give one entry for each output")
    missing = sum(o is None for o in out)
    new = iter(torch.empty((missing, *in0.shape), dtype=torch.int32,
                           device=in0.device).unbind() if missing else ())
    outs = []
    for o in out:
        if o is None:
            o = next(new)
        elif (o.shape != in0.shape or o.dtype is not torch.int32
              or o.device != in0.device or not o.is_contiguous()):
            raise ValueError("an output must be a contiguous int32 tensor "
                             "of the input's shape and device")
        outs.append(o)
    return tuple(outs)


def blocked_copy(inputs, x, pairs, *, block_rows: int = 64, out=None):
    """M2: for each (mul, add, adds_x) of ``pairs``, an int32 output
    ``inputs[0] * mul + add``, plus x[0] where ``adds_x``, over int32
    [rows, 128]; rows must be a multiple of ``block_rows``, the reference's
    grid step (the CUDA grid is ``copy_grid``'s).  The other inputs are
    operands the call passes and never reads.  ``out`` may give a tensor
    for each output (None: a new one); an output may be ``inputs[0]``
    itself, the in-place form of the TPU's ``input_output_aliases``.  At
    most eight inputs and eight outputs.  Returns the outputs
    (``copy_outputs``)."""
    in0 = inputs[0]
    if not in0.is_cuda:
        return blocked_copy_plain(inputs, x, pairs, block_rows=block_rows,
                                  out=out)
    global launches_copy
    shape = in0.shape
    if len(shape) != 2 or shape[1] != 128:
        raise ValueError("inputs[0] must be int32 [rows, 128]")
    try:
        params = _copy_params(shape[0], block_rows, len(inputs), pairs)
    except TypeError:  # pairs given as lists
        params = _copy_params(shape[0], block_rows, len(inputs),
                              tuple(map(tuple, pairs)))
    idx = in0.get_device()
    in_ptrs = [_ptr(t, idx, torch.int32, "input") for t in inputs]
    x_ptr = _ptr(x, idx, torch.int32, "x", 1)
    outs = copy_outputs(in0, len(pairs), out)
    err = _build.lib().dpvr_blocked_copy(
        *in_ptrs, *_NULLS[len(inputs):], *(o.data_ptr() for o in outs),
        *_NULLS[len(outs):], x_ptr, params,
        torch._C._cuda_getCurrentRawStream(idx))
    _build.check(err, "blocked_copy")
    launches_copy += 1
    return outs
