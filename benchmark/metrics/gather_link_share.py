"""The gather's bytes against its least time over NVLink, in %.

The bytes that cross into the first card a call: the three bands of the
2 x 2 layout that lie on other cards, 360 x 1280 pixels of colour and
depth each, 4 + 4 bytes a pixel (the few stats words left out).  Its
least time: those bytes at 450 GB/s, one direction of an H100 SXM's
NVLink (18 links of 25 GB/s each way; NVIDIA H100 data sheet, 900 GB/s
both ways).  The time: the union of the peer copies' intervals
(``peer_union_us``, the runner's reading of the profile), never their
sum, since the copies overlap on the first card's inbound links.  None
where the profile holds no peer copy."""

BYTES_PER_CALL = 3 * 360 * 1280 * (4 + 4)
LINK_BYTES_PER_S = 450e9


def read(ctx):
    p = ctx["profile"]
    union_us = p.get("peer_union_us")
    if not union_us or not p.get("frames"):
        return None
    least_s = BYTES_PER_CALL * p["frames"] / LINK_BYTES_PER_S
    return 100.0 * least_s / (union_us / 1e6)
