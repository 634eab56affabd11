"""Face packets: SoA batch views over packed quad streams.

Reference: src/meshing/face_packets.rs — ``FacePacket32`` groups 32 quads
of one face direction into 32-byte-aligned SoA arrays so AVX2 projection is
"load and go"; ``ChunkFacePackets`` holds the six per-direction packet
lists.

On TPU the whole per-chunk quad stream is already one SoA-decodable array
(quad_format.py) and the projection ops consume it directly, so packets are
a VIEW, not a storage format.  This module provides the API-parity
constructors plus the packet-shaped grouping (useful for tooling, tests,
and for code migrating from the reference), including the reference's
quirk-fix: packets here carry a per-quad ``axis_pos`` and per-packet
``slice_idx`` is only set when uniform (the reference reads
``axis_pos[0]`` for the whole packet — packet_pipeline.rs:100 — which is
only safe because its builder happens to group by slice; SURVEY.md flags
this as a latent assumption)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .quad_format import axis_pos as _axis_pos
from .quad_format import unpack_quads

PACKET_CAPACITY = 32  # face_packets.rs:9


@dataclass
class FacePacket32:
    """SoA arrays of up to 32 quads for one face direction
    (face_packets.rs:13-25)."""

    length: int
    u_min: np.ndarray
    v_min: np.ndarray
    u_len: np.ndarray
    v_len: np.ndarray
    axis_pos: np.ndarray
    block_type: np.ndarray

    @property
    def is_empty(self) -> bool:
        return self.length == 0

    @property
    def is_full(self) -> bool:
        return self.length >= PACKET_CAPACITY

    def slice_idx_uniform(self):
        """The packet's slice if all quads share one (see module note)."""
        ap = self.axis_pos[: self.length]
        return int(ap[0]) if len(ap) and (ap == ap[0]).all() else None


@dataclass
class ChunkFacePackets:
    """Per-direction packet lists (face_packets.rs:110-175)."""

    faces: list[list[FacePacket32]] = field(default_factory=lambda: [[] for _ in range(6)])

    @staticmethod
    def from_packed_quads(quads: np.ndarray) -> "ChunkFacePackets":
        """Group a packed quad stream into per-face packets of 32, keeping
        stream order (the builder flush-at-32 behavior,
        face_packets.rs:86-108)."""
        out = ChunkFacePackets()
        f = unpack_quads(quads)
        ap = _axis_pos(f["face"], f["slice_idx"])
        for face in range(6):
            idx = np.nonzero(f["face"] == face)[0]
            for start in range(0, len(idx), PACKET_CAPACITY):
                sel = idx[start : start + PACKET_CAPACITY]
                n = len(sel)

                def padded(a):
                    buf = np.zeros(PACKET_CAPACITY, a.dtype)
                    buf[:n] = a[sel]
                    return buf

                out.faces[face].append(
                    FacePacket32(
                        length=n,
                        u_min=padded(f["u"].astype(np.uint8)),
                        v_min=padded(f["v"].astype(np.uint8)),
                        u_len=padded(f["w"].astype(np.uint8)),
                        v_len=padded(f["h"].astype(np.uint8)),
                        axis_pos=padded(ap.astype(np.uint8)),
                        block_type=padded(f["block"].astype(np.uint8)),
                    )
                )
        return out

    def packet_count(self) -> int:
        return sum(len(p) for p in self.faces)

    def quad_count(self) -> int:
        return sum(pk.length for p in self.faces for pk in p)
