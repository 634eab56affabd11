"""Cells small enough for the CPU: a cell's configuration and traffic at
256 x 128 and view distance 3."""

from benchmark import spec


def tiny_cell(workload: str = "vd12_720p.pan"):
    return shrink(spec.cell(workload))


def shrink(c):
    r = dict(c.config["render"], width=256, height=128, gather_cap=16384,
             quads_cap=8192, tile_k_cap=16384, visible_chunks_cap=128)
    c.config = dict(c.config, render=r, pool_slots=1024,
                    world=dict(c.config["world"], view_distance=3))
    c.traffic = dict(c.traffic, warmup_frames=2)
    c.limits = dict(c.limits, sample=dict(frames=1, range=2, row_step=2),
                    trace=dict(after_frames=1, frames=2))
    return c
