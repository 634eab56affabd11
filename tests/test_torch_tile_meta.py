"""The default binning's stage 5 (``raster.tile_metadata_plain``, the twin
of the tile_meta kernel) against a numpy statement of its definition, on
hand-built item streams (tests/_torch_streams.py ``tile_meta_stream``):
one tile longer than 4096 items, empty tiles, octets that straddle tiles
and a kept count that is not a multiple of 8; and on the inputs a small
scene's render step hands it (``benches.common.meta_inputs``, which the
card test and chip_smoke.py use to take the step's stage-5 inputs).  The
kernel itself is held to the twin bit for bit on the card
(tests/test_torch_cuda.py).

The definition: records are the 22 rows gathered by item, then two zero
rows; an octet's rows are its 8 items' least first and greatest last
covered row, each against its own tile; an octet's near depth is the
least order-mapped near depth, its low ``bits_t`` bits cleared (bits_t =
the tile count's bit length), over its head item to the end of that
item's tile segment, and past the kept items U32 with those bits
cleared; both mapped back to float bits."""

import numpy as np
import pytest

import _torch_streams as TS
from differential_projection_voxel_renderer_tpu_torch.benches import common
from differential_projection_voxel_renderer_tpu_torch.ops import raster
from differential_projection_voxel_renderer_tpu_torch.rendering import parity
from differential_projection_voxel_renderer_tpu_torch.rendering import pipeline

# (seed, tiles_y, tiles_x, rc, n_items, long_tile, n_kept)
SHAPES = {
    "720p long tile": (3, 45, 10, 6000, 16384, 4100, None),
    "one tile": (4, 1, 1, 300, 2048, 0, 1501),
    "band 23x10": (5, 23, 10, 2500, 8192, 4097, 6003),
    "nothing kept": (6, 8, 10, 64, 512, 0, 0),
}


def _order_map(bits):
    """u32 float bits -> u32 keys in the floats' order."""
    return np.where(bits >> 31 != 0, ~bits, bits | np.uint32(1 << 31))


def _order_unmap(keys):
    return np.where(keys >> 31 != 0, keys & np.uint32(0x7FFFFFFF), ~keys)


def _numpy_metadata(all22, flat, t_of_item, starts, counts, *, tiles_y,
                    tiles_x, tile_h):
    n_items = flat.shape[0]
    n_tiles = tiles_y * tiles_x
    bits_t = max(1, int(n_tiles).bit_length())
    records = np.zeros((24, n_items), np.int32)
    records[:22] = all22[:, flat]
    tpy0 = (t_of_item // tiles_x) * tile_h
    bby = records[20]
    ly0 = np.clip((bby & 0xFFFF) - tpy0, 0, tile_h - 1)
    ly1 = np.clip((bby >> 16) - tpy0, 0, tile_h - 1)
    rows = ly0.reshape(-1, 8).min(1) | (ly1.reshape(-1, 8).max(1) << 8)
    keys = _order_map(records[21].view(np.uint32)) >> np.uint32(bits_t)
    n_kept = int(starts[-1] + counts[-1])
    zmin = np.empty(n_items // 8, np.uint32)
    for k in range(n_items // 8):
        i = 8 * k
        if i >= n_kept:
            low = np.uint32(0xFFFFFFFF) >> np.uint32(bits_t)
        else:
            t = t_of_item[i]
            low = keys[i:starts[t] + counts[t]].min()
        zmin[k] = _order_unmap(np.uint32(low) << np.uint32(bits_t))
    return records, rows.astype(np.int32), zmin.view(np.float32)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_tile_metadata_plain_matches_its_definition(shape):
    seed, ty, tx, rc, n_items, long_tile, n_kept = SHAPES[shape]
    ins, kw = TS.tile_meta_stream(seed, ty, tx, rc, n_items, long_tile,
                                  n_kept)
    starts, counts = ins[3].numpy(), ins[4].numpy()
    kept = int(starts[-1] + counts[-1])
    assert kept == (n_items - 5 if n_kept is None else n_kept)
    assert long_tile == 0 or counts.max() > 4096
    if kept > 0 and ty * tx > 2:
        assert (counts == 0).any()
        # octets that straddle two tiles
        ends = (starts + counts)[counts > 0]
        assert (ends % 8 != 0).any()
    got = raster.tile_metadata(*ins, **kw)  # CPU tensors: the twin
    want = _numpy_metadata(*(x.numpy() for x in ins), **kw)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy().view(np.int32),
                                  want[2].view(np.int32))


@pytest.mark.parametrize("scene", sorted(parity.SMALL_SCENES))
def test_meta_inputs_are_the_steps_stage_5(scene):
    """``meta_inputs`` takes what render_step hands tile_metadata, stops
    the step there and puts tile_metadata back: the twin on those inputs
    gives the step's own records, octet rows and octet_zmin, and so does
    the definition."""
    args, kw = parity.small_scene(scene, "cpu")
    real = raster.tile_metadata
    a, mkw = common.meta_inputs(lambda: pipeline.render_step(*args, **kw))
    assert raster.tile_metadata is real
    assert mkw["tiles_y"] * mkw["tiles_x"] == a[3].shape[0]
    rec = pipeline.render_step(*args, debug_return_records=True, **kw)
    assert int(rec[2].sum()) > 8
    want = _numpy_metadata(*(x.numpy() for x in a), **mkw)
    for got in (raster.tile_metadata_plain(*a, **mkw),
                (rec[0], rec[3], rec[4])):
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        np.testing.assert_array_equal(got[2].numpy().view(np.int32),
                                      want[2].view(np.int32))
