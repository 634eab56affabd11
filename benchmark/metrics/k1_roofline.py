"""K1 (stage A, ``project_cull_kernel``) against its least time, in %.

The least time is bytes over the card's memory rate (peaks.json): each
gathered quad's inputs read once (its 4-byte word and its chunk's 12-byte
float32 origin) and the per-quad fields of the reference's stage A written
once (the visible flag, 1 byte; the pixel box, four 16-bit bounds; the
near depth, 4 bytes): 29 bytes a quad of the stream, whose length is the
frame's ``stats[0]``, the gather's count (never K1's own outputs).
Operations (about 26 float32 operations a quad) bound it far less."""

from . import kernel_us

BYTES_PER_QUAD = 4 + 12 + 1 + 8 + 4


def read(ctx):
    p, peaks = ctx["profile"], ctx["peaks"]
    us = kernel_us(ctx, "project_cull_kernel")
    gathered = p.get("gathered") or []
    if not peaks or us <= 0 or not gathered:
        return None
    least_s = BYTES_PER_QUAD * sum(gathered) / peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (us / 1e6)
