"""Device-stage profile of the realistic workload on one GPU.

    python -m muscato_tpu.bench.stage_profile --Out FILE --Trace DIR

Generates the workload chip_smoke.py runs (gendat.generate_big, 8M reads
x 100 bp, half sampled from 100,000 genes x 1,000 bp with 2%
substitutions), loads it through the driver's own loaders, builds the
index once and times pipeline.run_matching_indexed against it, one device
batch per run, with MUSCATO_STAGE_TIMES on:

  first_call  one run in each pair order (DORDER 0, then 1): the first
              includes compiling probe, expand, verify and rank, the
              second the expand program of the other order
  ab          three runs of each order, alternating 0,1,1,0,0,1; the
              median device_s names the faster order
  counts      candidate pairs, pair buffer, unique (read, diagonal)
              count and verify while-loop trips, from one run's programs
  trace       one jax.profiler trace of a steady run in the faster order,
              reduced to kernel time per program, the compute stream's
              busy share of the traced span, and the top kernels

Prints one JSON object as the last line and writes it to --Out.  Runs on
a GPU only: with no GPU it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import statistics
import tempfile
import time

# chip_smoke.py's workload.
NUM_READ = 8_000_000
READ_LEN = 100
NUM_GENE = 100_000
GENE_LEN = 1_000
SEED = 0
REPS = 3


def _merged_busy_ns(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def summarize_trace(data, top: int = 12) -> dict:
    """Reduce a jax.profiler ProfileData to the device's kernel time: for
    the busiest GPU stream, its kernel time by program (hlo_module), the
    union of its kernel intervals against the span from first start to
    last end, and the top kernels by time (instance suffixes __N merged)."""
    best = None
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = [(e.name, e.start_ns, e.duration_ns, dict(e.stats))
                   for e in line.events]
            total = sum(d for _, _, d, _ in evs)
            if evs and (best is None or total > best[2]):
                best = (plane.name, line.name, total, evs)
    if best is None:
        raise ValueError("the trace holds no GPU kernel")
    plane, line, total, evs = best
    span = max(s + d for _, s, d, _ in evs) - min(s for _, s, _, _ in evs)
    busy = _merged_busy_ns([(s, s + d) for _, s, d, _ in evs])
    by_program: dict = {}
    kernels: dict = {}
    for name, _, d, stats in evs:
        mod = stats.get("hlo_module", "?")
        by_program[mod] = by_program.get(mod, 0.0) + d
        k = kernels.setdefault(re.sub(r"__\d+$", "", name), [0.0, 0])
        k[0] += d
        k[1] += 1
    top_k = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "device": plane,
        "stream": line,
        "kernel_ms": total / 1e6,
        "busy_ms": busy / 1e6,
        "span_ms": span / 1e6,
        "idle_share": 1.0 - busy / span if span else 0.0,
        "by_program_ms": {k: v / 1e6 for k, v in sorted(
            by_program.items(), key=lambda kv: -kv[1])},
        "top_kernels": [[n[:120], ms / 1e6, c] for n, (ms, c) in top_k],
    }


def ab_orders(reps: int) -> list:
    """0,1,1,0,0,1,...: each order as often first as second."""
    out = []
    for i in range(reps):
        out += [0, 1] if i % 2 == 0 else [1, 0]
    return out


def main(argv=None) -> int:
    from .runner import card_info, require_gpu

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--Out", required=True, help="JSON result file")
    ap.add_argument("--Trace", required=True,
                    help="directory for the jax.profiler trace")
    ns = ap.parse_args(argv)

    dev = require_gpu()

    import jax

    from .. import cli
    from ..config import Config
    from ..engine import pipeline
    from ..engine.driver import enable_compile_cache
    from ..engine.index import build_target_index
    from ..io import native
    from ..io import reads as reads_io
    from ..io import targets as targets_io
    from ..ops import fused
    from . import gendat
    from .dispatches import record_dispatches

    enable_compile_cache()
    native.ensure_built()
    os.environ["MUSCATO_STAGE_TIMES"] = "1"
    card = card_info()
    print(card, flush=True)

    cfg = Config(Windows=[10, 30, 50, 70], WindowWidth=20, PMatch=0.96,
                 MinDinuc=3, MaxReadLength=200, MMTol=2, MaxMatches=10**6,
                 MatchMode="best", ReadBatch=1 << 23)
    host: dict = {}
    workdir = tempfile.mkdtemp(prefix="stage_profile_")
    try:
        t0 = time.perf_counter()
        reads_path, genes_path = gendat.generate_big(
            NUM_READ, READ_LEN, NUM_GENE, GENE_LEN, out_dir=workdir,
            seed=SEED)
        if cli.main_prep_targets([genes_path]) != 0:
            raise SystemExit("muscato_prep_targets failed")
        seq_path, ids_path = targets_io.prepared_names(genes_path)
        host["generate_and_prep_targets_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rs = reads_io.build_readset(reads_path, cfg.MinReadLength,
                                    cfg.MaxReadLength)
        host["build_readset_s"] = time.perf_counter() - t0
        host["unique_reads"] = rs.num_unique
        t0 = time.perf_counter()
        ts = targets_io.load_targets(seq_path, ids_path)
        host["load_targets_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    index = build_target_index(ts, cfg.WindowWidth)
    index.skeys.block_until_ready()
    host["index_build_s"] = time.perf_counter() - t0
    host["index_build_detail"] = index.build_timings
    pipeline.preload_device_batch(cfg, rs)

    def run(order: int) -> dict:
        fused.set_dorder(bool(order))
        tm: dict = {}
        t0 = time.perf_counter()
        mr = pipeline.run_matching_indexed(cfg, rs, index, timings=tm)
        tm["wall_s"] = time.perf_counter() - t0
        tm["rows"] = len(mr.read_row)
        tm["dorder"] = order
        print(json.dumps(tm), flush=True)
        return tm

    first_call = {o: run(o) for o in (0, 1)}
    ab = [run(o) for o in ab_orders(REPS)]
    median = {o: statistics.median(r["device_s"] for r in ab
                                   if r["dorder"] == o) for o in (0, 1)}
    faster = min(median, key=median.get)

    with record_dispatches(keep_outputs=True) as rec:
        run(faster)
    (exp,) = rec.by_stage("expand")
    ver = rec.by_stage("verify")[-1]
    nuniq = int(exp.last_out[4])
    vchunk = ver.kwargs["vchunk"]
    counts = {
        "pairs": int(exp.last_out[5]),
        "pair_cap": exp.kwargs["pair_cap"],
        "unique_diagonals": nuniq,
        "vchunk": vchunk,
        "verify_trips": -(-nuniq // vchunk),
        "surv_cap": ver.kwargs["surv_cap"],
    }
    del rec

    os.makedirs(ns.Trace, exist_ok=True)
    with jax.profiler.trace(ns.Trace):
        traced = run(faster)
    (path,) = sorted(glob.glob(os.path.join(
        ns.Trace, "plugins", "profile", "*", "*.xplane.pb")))[-1:]
    trace = summarize_trace(jax.profiler.ProfileData.from_file(path))

    result = {
        "card": card,
        "device_kind": dev.device_kind,
        "host": host,
        "first_call": first_call,
        "ab": ab,
        "median_device_s": median,
        "faster_dorder": faster,
        "counts": counts,
        "traced_run": traced,
        "trace": trace,
        "peak_bytes_in_use": dev.memory_stats()["peak_bytes_in_use"],
    }
    if os.path.dirname(ns.Out):
        os.makedirs(os.path.dirname(ns.Out), exist_ok=True)
    with open(ns.Out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
