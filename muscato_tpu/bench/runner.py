"""Benchmark harness: reads/s on the screen+confirm (probe+verify) core.

The reference publishes no numbers (BASELINE.md).  Two workloads are
measured:

  big    8M reads x 100bp sampled (with substitutions) from 100,000 genes
         x 1000bp — a 100M-base index with realistic hit density.  This is
         the headline number.
  small  4M random reads vs 2,000 genes x 1000bp (2M bases); probes
         mostly miss, so it measures window extraction + probe overhead.

The timed region covers the per-batch work a production mapper would do
against a prebuilt index: window key extraction, index probe, pair
expansion, verification, and the on-device parts of dedup/rank.  Index
build and host report formatting are reported separately.  Repetitions use
shifted read subsets.  The benchmark runs on a GPU only: with no GPU it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass

from ..config import Config
from ..engine import pipeline
from ..engine.index import build_target_index
from . import gendat

@dataclass
class BenchResult:
    reads_per_sec: float
    unique_reads: int
    total_reads: int
    num_genes: int
    gene_bases: int
    index_build_s: float
    match_s: float
    matches: int
    with_transfers_s: float = 0.0
    result_fetch_s: float = 0.0
    result_fetch_bytes: int = 0
    end_to_end_s: float = 0.0
    index_build_detail: dict | None = None
    stage_times: dict | None = None


def _subset(rs, shift: int, n: int):
    """A shifted n-read window of the pool (one per timing repetition)."""
    from ..io.reads import ReadSet

    nu = rs.num_unique
    lo = min(shift, max(nu - n, 0))
    return ReadSet(
        codes=rs.codes[lo : lo + n], lengths=rs.lengths[lo : lo + n],
        counts=rs.counts[lo : lo + n],
        name_blob=rs.name_blob, name_off=rs.name_off[lo : lo + n + 1],
        num_total=n,
    )


def _bench_one(cfg: Config, rs, ts, num_read: int, repeats: int) -> BenchResult:
    t0 = time.perf_counter()
    index = build_target_index(ts, cfg.WindowWidth)
    index.skeys.block_until_ready()
    index_build_s = time.perf_counter() - t0
    index_build_detail = index.build_timings

    n = rs.num_unique
    # Warmup (compile all shapes) on a subset none of the reps reuse.
    warm = _subset(rs, repeats, n - repeats)
    pipeline.run_matching_indexed(cfg, warm, index)

    # Timed reps: device arrays are staged beforehand, so the timed region
    # is device compute + result fetch.
    subs = [_subset(rs, rep, n - repeats) for rep in range(repeats)]
    for sub in subs:
        pipeline.preload_device_batch(cfg, sub)
    best = float("inf")
    best_e2e = float("inf")
    fetch_s = 0.0
    fetch_bytes = 0
    matches = 0
    stage_times = None
    for sub in subs:
        tm: dict = {}
        t0 = time.perf_counter()
        mr = pipeline.run_matching_indexed(cfg, sub, index, timings=tm)
        dt = time.perf_counter() - t0
        # Headline times the device phase (synced per batch by scalar
        # fetches); the bulk retained-row copy is reported separately.
        if tm.get("device_s", dt) < best:
            best = tm.get("device_s", dt)
            fetch_s = tm.get("fetch_s", 0.0)
            fetch_bytes = tm.get("fetch_bytes", 0)
            stage_times = tm.get("stages")
        best_e2e = min(best_e2e, dt)
        matches = len(mr.read_row)

    # One unstaged pass: includes the host->device read upload.
    sub = _subset(rs, repeats + 1, n - repeats - 1)
    t0 = time.perf_counter()
    pipeline.run_matching_indexed(cfg, sub, index)
    with_transfers = time.perf_counter() - t0

    return BenchResult(
        reads_per_sec=num_read / best,
        unique_reads=rs.num_unique,
        total_reads=num_read,
        num_genes=ts.num_genes,
        gene_bases=int(ts.gene_start[-1]),
        index_build_s=index_build_s,
        match_s=best,
        matches=matches,
        with_transfers_s=with_transfers,
        result_fetch_s=fetch_s,
        result_fetch_bytes=fetch_bytes,
        end_to_end_s=best_e2e,
        index_build_detail=index_build_detail,
        stage_times=stage_times,
    )


def run_bench_big(
    num_read: int = 4_000_000,
    read_len: int = 100,
    num_gene: int = 100_000,
    gene_len: int = 1_000,
    windows=(10, 30, 50, 70),
    window_width: int = 20,
    pmatch: float = 0.96,
    repeats: int = 3,
    seed: int = 0,
    read_batch: int = 0,
) -> BenchResult:
    cfg = Config(
        Windows=list(windows), WindowWidth=window_width, PMatch=pmatch,
        MinDinuc=3, MaxReadLength=read_len * 2, MMTol=2,
        MaxMatches=10**6, MatchMode="best",
        ReadBatch=read_batch,
    )
    rs, ts = gendat.generate_arrays_realistic(
        num_read, read_len, num_gene, gene_len, seed
    )
    return _bench_one(cfg, rs, ts, num_read, repeats)


def run_bench(
    num_read: int = 4_000_000,
    read_len: int = 100,
    num_gene: int = 2_000,
    gene_len: int = 1_000,
    windows=(10, 30, 50, 70),
    window_width: int = 20,
    pmatch: float = 0.96,
    repeats: int = 3,
    seed: int = 0,
) -> BenchResult:
    cfg = Config(
        Windows=list(windows), WindowWidth=window_width, PMatch=pmatch,
        MinDinuc=3, MaxReadLength=read_len * 2, MMTol=2,
        MaxMatches=10**6, MatchMode="best",
    )
    rs, ts = gendat.generate_arrays(num_read, read_len, num_gene, gene_len, seed)
    return _bench_one(cfg, rs, ts, num_read, repeats)


def _detail(r: BenchResult) -> dict:
    d = {
        "match_device_s": round(r.match_s, 4),
        "result_fetch_s": round(r.result_fetch_s, 4),
        "result_fetch_bytes": r.result_fetch_bytes,
        "end_to_end_s": round(r.end_to_end_s, 4),
        "with_transfers_s": round(r.with_transfers_s, 4),
        "index_build_s": round(r.index_build_s, 4),
        "unique_reads": r.unique_reads,
        "gene_bases": r.gene_bases,
        "matches": r.matches,
        "reads_per_sec": round(r.reads_per_sec, 1),
    }
    if r.index_build_detail:
        d["index_build_detail"] = r.index_build_detail
    if r.stage_times:
        d["stage_times"] = r.stage_times
    return d


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reports them (one
    line per card)."""
    import subprocess

    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def require_gpu():
    """The first JAX device, which must be a GPU: a measurement that finds
    no GPU exits non-zero instead of timing another backend."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU found: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this measurement runs on a GPU only"
        )
    return dev


def main(argv=None) -> int:
    import argparse
    import logging
    import os

    import jax

    from ..engine.driver import enable_compile_cache
    from ..io import native

    dev = require_gpu()
    enable_compile_cache()
    native.ensure_built()  # fast index sort; graceful fallback if no g++

    # Per-batch stage breakdown rides the loop's existing scalar syncs
    # (near-zero cost) and lands in the bench detail.
    os.environ.setdefault("MUSCATO_STAGE_TIMES", "1")

    if os.environ.get("MUSCATO_BENCH_LOG", "1") != "0":
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(name)s %(message)s",
        )

    p = argparse.ArgumentParser()
    p.add_argument("--Workload", choices=("big", "small", "both"), default="both")
    p.add_argument("--NumRead", type=int, default=8_000_000)
    p.add_argument("--ReadLen", type=int, default=100)
    p.add_argument("--NumGene", type=int, default=0)  # 0 = workload default
    p.add_argument("--GeneLen", type=int, default=1_000)
    p.add_argument("--Repeats", type=int, default=3)
    p.add_argument("--ReadBatch", type=int, default=0,
                   help="device read-batch size for the big workload "
                        "(0 = one 8M-row batch)")
    ns = p.parse_args(argv)

    from ..ops import fused

    detail = {}
    headline = None
    if ns.Workload in ("big", "both"):
        headline = run_bench_big(
            num_read=ns.NumRead, read_len=ns.ReadLen,
            num_gene=ns.NumGene or 100_000, gene_len=ns.GeneLen,
            repeats=ns.Repeats,
            read_batch=ns.ReadBatch or (1 << 23),
        )
        detail["big"] = _detail(headline)
    if ns.Workload in ("small", "both"):
        r = run_bench(
            num_read=min(ns.NumRead, 4_000_000), read_len=ns.ReadLen,
            num_gene=ns.NumGene or 2_000, gene_len=ns.GeneLen,
            repeats=ns.Repeats,
        )
        if headline is None:
            headline = r
        detail["small"] = _detail(r)

    detail["dorder"] = int(fused.dorder_enabled())
    detail["platform"] = dev.platform
    detail["device_kind"] = dev.device_kind
    detail["device_count"] = len(jax.devices())
    detail["card"] = card_info()
    print(json.dumps({
        "metric": "reads_per_sec",
        "value": round(headline.reads_per_sec, 1),
        "unit": "reads/s",
        "detail": detail,
    }))
    return 0
