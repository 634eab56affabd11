"""Sort shapes on the card: one flat sort against a batched [B, N/B] sort
and a bitonic merge of the sorted rows.

The counterpart of ``benches/micro_sort.py`` at its sizes: the step's two
mid-stage sorts, 131072 keys (the compaction) and 262144 (the binning),
each u32 key held in an int64 as the step holds it.  ``flat_sort_N`` is
one ``torch.sort``; ``batched_sort_N_bB`` sorts [B, N/B] rows and merges
them with bitonic merges in torch ops (``merge_sorted_rows``).  Each case
runs K iterations (``--k``, default 50; iteration i sorts x + i, and a
checksum reads every sorted position) captured in one CUDA graph: the
median over 5 replays of the graph's CUDA-event time, over K.  The merge
is checked against numpy's sort at each size; a wrong merge raises.

    python -m differential_projection_voxel_renderer_tpu_torch.benches.micro_sort [--k K]

One JSON line a case to stdout, ``{"case": ..., "ms": ...}``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .common import graph_ms, need_card
from .scene import log

SIZES = (131072, 262144)
BATCHES = (2, 4, 8)


def bitonic_merge_pow2(x):
    """A bitonic sequence x [N] (N a power of two) -> sorted ascending:
    log2(N) compare-exchange passes, each a reshape and a min/max of the
    halves."""
    n = x.shape[0]
    span = n // 2
    while span >= 1:
        v = x.reshape(-1, 2, span)
        lo = torch.minimum(v[:, 0], v[:, 1])
        hi = torch.maximum(v[:, 0], v[:, 1])
        x = torch.stack([lo, hi], 1).reshape(-1)
        span //= 2
    return x


def merge_sorted_rows(rows):
    """[B, M], each row ascending (B a power of two) -> [B * M] ascending,
    by two-way bitonic merges (one side reversed)."""
    b = rows.shape[0]
    while b > 1:
        rows = torch.stack([bitonic_merge_pow2(torch.cat(
            [rows[i], rows[i + 1].flip(0)])) for i in range(0, b, 2)])
        b //= 2
    return rows[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=50)
    a = ap.parse_args(argv)
    need_card()
    k = a.k
    rng = np.random.default_rng(0)

    def timeit(fn, label):
        ms = graph_ms(fn, calls=1, reps=5) / k
        log(f"{label:>28}: {ms:.4f} ms")
        print(json.dumps({"case": label, "ms": round(ms, 4)}), flush=True)

    for n in SIZES:
        base = rng.integers(0, 2**32 - 1, size=n, dtype=np.uint32)
        x = torch.from_numpy(base.astype(np.int64)).cuda()
        # the checksum reads every position of the sorted keys
        w = torch.from_numpy(rng.integers(0, 2**32 - 1, size=n,
                                          dtype=np.uint32).astype(
                                              np.int64)).cuda()

        def flat(x=x, w=w):
            for i in range(k):
                (torch.sort(x + i).values * w).sum()

        timeit(flat, f"flat_sort_{n}")
        for b in BATCHES:
            def batched(x=x, w=w, b=b):
                for i in range(k):
                    rows = torch.sort((x + i).reshape(b, n // b), 1).values
                    (merge_sorted_rows(rows) * w).sum()

            timeit(batched, f"batched_sort_{n}_b{b}")
        merged = merge_sorted_rows(torch.sort(x.reshape(4, n // 4),
                                              1).values)
        if not np.array_equal(merged.cpu().numpy(), np.sort(base)):
            raise AssertionError(f"merge wrong at n={n}")
        log(f"merge correctness OK at n={n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
