"""The cost-probe path on the card (kernels M1, M2 and K2 on an empty
stream), in one tree or in turns across two trees.

    python differential_projection_voxel_renderer_tpu_torch/benches/probe_call.py [--tree DIR] [--out FILE]
    python differential_projection_voxel_renderer_tpu_torch/benches/probe_call.py --turns DIR_A DIR_B [--out FILE]

With ``--tree`` (by default the tree this file lies in) it imports the
port package found in DIR, builds its kernels and drives every probe
variant once -- micro_fixed's levels, micro_fixed2's 63 labels and its
SOLO10 sweep (x = ``PROBE_X``), micro_fixed3's levels and h variants --
through its module's ``run_variant``, with the launch counters read
before and after (each variant must launch its kernel as often as it
calls it); every output must equal the plain versions' bit for bit where
the kernel writes (micro_fixed's and micro_fixed3's levels 1-2 also on
random tile counts), and K2's empty frame must be the constant frame.
Then it times each variant (``common.measure``: a call, in runs of 20, 30
queued, host us a call, from a CUDA graph), its plain version and its
library call (``library_call``) in runs of 20, from a CUDA graph and by
host us, and the graph launch floor (``torch.cuda._sleep(0)``, a launch
that does no work, from a CUDA graph), and derives each variant's bound
and launches x floor + bound (``derive``); with the lean wrappers it also
times where a call's host time goes (``host_parts``).  It writes one
JSON object to FILE (default ``probe_call.json`` in the current
directory) and prints a summary line.  Apart from
``host_parts`` it calls only the modules' public entry points
(``variant``, ``prepare``, ``run_variant``, ``time_variant``), so it
reads any tree of the port since the probes.

With ``--turns`` it runs DIR_A, DIR_B, DIR_B, DIR_A, each in a process of
its own, derives every turn's bounds from this tree's variant
definitions (so both trees are held to the same bytes and launches),
writes all four turns to FILE and prints a summary line a turn and the
card's name and power limit (nvidia-smi).  Needs a CUDA card; imports
nothing of the JAX package; ~30 s a turn on an H100, the kernels' build
included.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PKG = "differential_projection_voxel_renderer_tpu_torch"
# micro_fixed2's scalar x (SKY + x must differ from SKY)
PROBE_X = 7
# the H100 SXM data sheet's HBM rate at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
# "near" a floor: a graph time at most this times launches x floor + bound
NEAR = 1.5


def modules(tree: str | None = None, build: bool = True) -> dict:
    """The tree's probe modules and what they drive: {"build", "common",
    "micro", "raster", "micro_fixed", "micro_fixed2", "micro_fixed3"}, its
    kernels built unless ``build`` is false.  With ``tree``, that tree's
    package is imported (it must not be imported yet)."""
    if tree is not None:
        sys.path.insert(0, tree)
    import importlib

    mods = {name: importlib.import_module(f"{PKG}.{path}") for name, path in (
        ("build", "_build"), ("common", "benches.common"),
        ("micro", "ops.micro"), ("raster", "ops.raster"),
        ("micro_fixed", "benches.micro_fixed"),
        ("micro_fixed2", "benches.micro_fixed2"),
        ("micro_fixed3", "benches.micro_fixed3"))}
    if tree is not None and not os.path.abspath(
            mods["build"].__file__).startswith(os.path.abspath(tree) + os.sep):
        raise RuntimeError(f"imported {mods['build'].__file__}, not from "
                           f"{tree}")
    if build:
        mods["build"].build()
    return mods


def variants(mods) -> list:
    """[(module name, label, run arguments)] of every probe variant."""
    return ([("micro_fixed", str(lv), ())
             for lv in mods["micro_fixed"].LEVELS]
            + [("micro_fixed2", lab, (PROBE_X,))
               for lab in mods["micro_fixed2"].LABELS
               + mods["micro_fixed2"].SWEEP]
            + [("micro_fixed3", lab, ())
               for lab in mods["micro_fixed3"].LABELS])


def launches(mods) -> tuple:
    """Launch counts of M1, M2 and K2."""
    return (mods["micro"].launches_fill, mods["micro"].launches_copy,
            mods["raster"].launches)


def library_call(torch, v, outs, x: int = PROBE_X):
    """The PyTorch calls that compute a variant's kernel calls on the same
    inputs into its outputs: ``Tensor.fill_`` of each output with its value
    (M1, and K2 on the empty stream, whose frame is constant), or
    ``torch.add`` into each output for each of M2's calls (the variant's
    own torch ops around its calls are not in it)."""
    if v.kernel in ("M1", "K2"):
        vals = [o.reshape(-1)[0].clone() for o in outs]
        return lambda: [o.fill_(c) for o, c in zip(outs, vals)]
    in0 = torch.zeros_like(outs[0])
    adds = [torch.tensor(a + (x if ax else 0), dtype=torch.int32,
                         device=in0.device) for _, a, ax in v.pairs]

    def lib():
        for _ in range(v.calls):
            for (m, _, _), o, c in zip(v.pairs, outs, adds):
                torch.add(in0, in0 if m == 2 else c, out=o)
    return lib


def drive(torch, mods) -> tuple[dict, tuple]:
    """Every variant once through run_variant, each launching its kernel
    as often as it calls it.  Returns ({(module, label): (variant,
    outputs)}, the launches of M1, M2 and K2 in all)."""
    outs = {}
    expect = [0, 0, 0]
    torch.cuda.synchronize()
    start = launches(mods)
    for name, label, args in variants(mods):
        mod = mods[name]
        v = mod.variant(label)
        before = launches(mods)
        outs[name, label] = (v, mod.run_variant(label, *args))
        got = tuple(a - b for a, b in zip(launches(mods), before))
        k = ("M1", "M2", "K2").index(v.kernel)
        want = tuple(v.calls if i == k else 0 for i in range(3))
        if got != want:
            raise AssertionError(f"{name} {label} launched M1, M2, K2 "
                                 f"{got}, expected {want}")
        expect[k] += v.calls
    torch.cuda.synchronize()
    total = tuple(a - b for a, b in zip(launches(mods), start))
    if total != tuple(expect):
        raise AssertionError(f"probe launches {total}, expected {expect}")
    return outs, total


def check(torch, mods, outs) -> dict:
    """``drive``'s outputs against the plain versions, as the module
    docstring says.  Returns the max abs error of each kernel against its
    plain version."""
    common = mods["common"]
    errs = {"M1": 0.0, "M2": 0.0, "K2": 0.0}
    for name, label, args in variants(mods):
        v, got = outs[name, label]
        ref = mods[name].run_variant(label, *args, plain=True)
        if not common.same_bits(v.written(got), v.written(ref)):
            raise AssertionError(f"{name} {label}: {v.kernel} differs from "
                                 f"its plain version")
        for a, b in zip(v.written(got), v.written(ref)):
            d = (a.double() - b.double()).abs()
            d = d[torch.isfinite(d)]
            if d.numel():
                errs[v.kernel] = max(errs[v.kernel], float(d.max()))
    for name in ("micro_fixed", "micro_fixed3"):
        mod = mods[name]
        inputs = mod.build_inputs(seed=11)
        for level in ("1", "2"):
            if not common.same_bits(mod.run_variant(level, inputs),
                                    mod.run_variant(level, inputs,
                                                    plain=True)):
                raise AssertionError(f"{name} level {level} on random tile "
                                     f"counts differs from its plain version")
    c3, d3 = outs["micro_fixed3", "3"][1]
    if not (bool((c3 == mods["raster"].SKY_I32).all())
            and bool(torch.isinf(d3).all()) and bool((d3 > 0).all())):
        raise AssertionError("K2 on the empty stream is not the constant "
                             "frame")
    return errs


def time_rows(torch, mods, outs) -> tuple[dict, float]:
    """Each variant's times ({(module, label): {...}}) and the graph
    launch floor in ms."""
    common = mods["common"]
    rows = {}
    for name, label, args in variants(mods):
        mod = mods[name]
        v, got = outs[name, label]
        t = mod.time_variant(label, *args)
        t["plain_ms"] = common.median_ms(
            mod.prepare(label, *args, plain=True), reps=5)
        lib = library_call(torch, v, got)
        t.update(library_ms=common.median_ms(lib, batch=20),
                 library_graph_ms=common.graph_ms(lib),
                 library_host_us=common.host_us(lib),
                 kernel=v.kernel, site=v.site, launches=v.calls)
        rows[name, label] = t
    floor_ms = common.graph_ms(lambda: torch.cuda._sleep(0))
    return rows, floor_ms


def derive(rows: dict, floor_ms: float, mods) -> None:
    """Add to each row, from ``mods``' variant definitions: its bytes,
    ``bound_ms`` (bytes over the HBM rate), ``floor_bound_ms`` (kernel
    launches x floor + bound), ``run_floor_bound_ms`` (the same with the
    torch ops the run makes around its calls), whether the graph time is
    within them (``within_floor``, ``near``: within NEAR times,
    ``run_near``), and whether the variant in runs is no slower than its
    library call (``beats_library``)."""
    for (name, label), t in rows.items():
        v = mods[name].variant(label)
        ops, ops_bytes = getattr(v, "torch_ops", (0, 0))
        t.update(bytes=v.bytes, torch_launches=ops, torch_bytes=ops_bytes,
                 bound_ms=v.bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
        t["floor_bound_ms"] = v.calls * floor_ms + t["bound_ms"]
        t["run_floor_bound_ms"] = ((v.calls + ops) * floor_ms
                                   + (v.bytes + ops_bytes)
                                   / HBM_BYTES_PER_S * 1e3)
        t["within_floor"] = t["graph_ms"] <= t["floor_bound_ms"]
        t["near"] = t["graph_ms"] <= NEAR * t["floor_bound_ms"]
        t["run_near"] = t["graph_ms"] <= NEAR * t["run_floor_bound_ms"]
        t["beats_library"] = t["run_ms"] <= t["library_ms"]


def summary(rows: dict, floor_ms: float) -> dict:
    """Counts a kernel: variants, within launches x floor + bound, within
    NEAR times it, within NEAR times it with the torch ops counted, and no
    slower in runs than the library call."""
    out = {}
    for kernel in ("M1", "M2"):
        ts = [t for t in rows.values() if t["kernel"] == kernel]
        out[kernel] = dict(
            variants=len(ts), within=sum(t["within_floor"] for t in ts),
            near=sum(t["near"] for t in ts),
            run_near=sum(t["run_near"] for t in ts),
            beats_library=sum(t["beats_library"] for t in ts))
    out["floor_ms"] = floor_ms
    return out


def host_parts(torch, mods, turns: int = 7) -> dict:
    """Where a call's host time goes: host us (median of ``turns`` blocks
    of 50 calls, taken in turns) of M1's call at a_base and M2's at 1x1
    and 4x5 through their variants, and of their pieces alone -- the
    outputs (``fill_outputs``, ``copy_outputs``), one ``torch.empty`` of
    the same bytes, the operand checks, the C entry point with prepared
    pointers, the current stream's raw handle -- beside the library calls
    ``Tensor.fill_`` x2 and ``torch.add`` x1 into existing tensors.  Needs
    the lean wrappers' helpers (``micro.fill_outputs``)."""
    common, micro, m2 = mods["common"], mods["micro"], mods["micro_fixed2"]
    lib = mods["build"].lib()
    stream = torch.cuda.current_stream().cuda_stream
    xs = torch.zeros(1, dtype=torch.int32, device="cuda")
    ins = [torch.zeros((1024, 128), dtype=torch.int32, device="cuda")
           for _ in range(9)]
    a_base = m2.variant("a_base").layout
    fout = micro.fill_outputs(a_base, "cuda")
    m1_ptrs = (*(o.data_ptr() for o in fout), xs.data_ptr(), *(None,) * 12,
               a_base.c_params, stream)
    p45 = micro._copy_params(1024, 64, 4, tuple((1, i, True)
                                                for i in range(5)))
    p11 = micro._copy_params(1024, 64, 1, ((1, 0, True),))
    m2_45 = (*(t.data_ptr() for t in ins[:4]), *(None,) * 4,
             *(t.data_ptr() for t in ins[4:]), *(None,) * 3, xs.data_ptr(),
             p45, stream)
    m2_11 = (ins[0].data_ptr(), *(None,) * 7, ins[1].data_ptr(),
             *(None,) * 7, xs.data_ptr(), p11, stream)
    val = torch.tensor(5, dtype=torch.int32, device="cuda")
    i32 = torch.int32
    fns = {
        "M1 a_base call": m2.prepare("a_base", PROBE_X),
        "M1 outputs (fill_outputs)": lambda: micro.fill_outputs(a_base,
                                                                "cuda"),
        "torch.empty of M1's outputs' bytes": lambda: torch.empty(
            (2, 736, 1280), dtype=i32, device="cuda"),
        "M1 C entry": lambda: lib.dpvr_fill_tiles(*m1_ptrs),
        "M2 1x1 call": m2.prepare("solo10_1x1", PROBE_X),
        "M2 4x5 call": m2.prepare("solo10_4x5", PROBE_X),
        "M2 outputs, 1 (copy_outputs)": lambda: micro.copy_outputs(ins[0],
                                                                   1),
        "M2 outputs, 5 (copy_outputs)": lambda: micro.copy_outputs(ins[0],
                                                                   5),
        "M2 operand checks, 5": lambda: [micro._ptr(t, 0, i32, "in")
                                         for t in ins[:5]],
        "M2 C entry 1x1": lambda: lib.dpvr_blocked_copy(*m2_11),
        "M2 C entry 4x5": lambda: lib.dpvr_blocked_copy(*m2_45),
        "raw stream handle": lambda: torch._C._cuda_getCurrentRawStream(0),
        "library fill_ x2": lambda: [o.fill_(val) for o in fout],
        "library torch.add x1": lambda: torch.add(ins[0], val, out=ins[1]),
    }
    per = {k: [] for k in fns}
    for _ in range(turns):
        for k, fn in fns.items():
            per[k].append(common.host_us(fn, blocks=1))
    return {k: statistics.median(v) for k, v in per.items()}


def one_tree(tree: str) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("probe_call needs a CUDA card")
    mods = modules(tree)
    outs, total = drive(torch, mods)
    errs = check(torch, mods, outs)
    rows, floor_ms = time_rows(torch, mods, outs)
    parts = (host_parts(torch, mods)
             if hasattr(mods["micro"], "fill_outputs") else None)
    return dict(tree=tree, floor_ms=floor_ms, errors=errs, launches=total,
                host_parts=parts,
                rows={f"{n} {lab}": t for (n, lab), t in rows.items()})


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--turns", nargs=2, metavar=("DIR_A", "DIR_B"))
    ap.add_argument("--out", default="probe_call.json")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        res = one_tree(os.path.abspath(a.tree))
        with open(a.out, "w") as f:
            json.dump(res, f)
        return 0
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    trees = ([os.path.abspath(a.tree)] if not a.turns else
             [os.path.abspath(d) for d in (a.turns[0], a.turns[1],
                                           a.turns[1], a.turns[0])])
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, d in enumerate(trees):
            path = os.path.join(tmp, f"turn{i}.json")
            out = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--worker", "--tree", d, "--out", path],
                                 capture_output=True, text=True, timeout=900)
            if out.returncode:
                print(out.stdout + out.stderr, file=sys.stderr)
                return out.returncode
            with open(path) as f:
                turns.append(json.load(f))
    # every turn's bounds from this tree's variant definitions
    mods = modules(HERE, build=False)
    card = smi_line()
    for res in turns:
        rows = {tuple(k.split(" ", 1)): t for k, t in res["rows"].items()}
        derive(rows, res["floor_ms"], mods)
        res["summary"] = summary(rows, res["floor_ms"])
        med = {k: statistics.median(t[k] for t in rows.values())
               for k in ("graph_ms", "host_us", "run_ms")}
        print(json.dumps(dict(tree=res["tree"], summary=res["summary"],
                              medians=med, host_parts=res["host_parts"])),
              flush=True)
    with open(a.out, "w") as f:
        json.dump(dict(card=card, turns=turns), f)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
