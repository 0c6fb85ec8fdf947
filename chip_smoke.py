#!/usr/bin/env python
"""Smoke test of the muscato main path on the GPU.

    python chip_smoke.py             # one card: the phases below
    python chip_smoke.py --cards 4   # four cards: the mesh path only

One card runs these phases, each ending in one line with its wall time:

  device        JAX's first device must be a GPU (no CPU fallback); prints
                the card's name and power limit, the JAX version, the
                device count, XLA_FLAGS and the compile-cache directory.
  oracle        small seeded cases through pipeline.run_matching on the
                card, compared with the brute-force oracle
                (tests/oracle.py) by exact set equality.
  main.generate generates the realistic workload (100,000 genes x 1,000
                bp, 8M reads x 100 bp, half sampled from the genes with 2%
                substitutions) on disk and runs muscato_prep_targets.
  main.muscato  runs muscato through the console-script function, prints
                the stage times from the run's logs and the end-to-end
                reads/s.
  compile       for every device program that run dispatched (probe,
                expand, verify, rank): its compile seconds at first call,
                as JAX reported them during the run, and memory_analysis()
                of the same jitted program at the same shapes.
  main.check    re-checks every row of results.txt on the host.
  parity        a JAX_PLATFORMS=cpu subprocess and the card run muscato on
                the first 100,000 reads against the same targets; results,
                nonmatch fastq and read/gene stats must be byte-identical.

--cards 4 generates the same data and runs muscato with --Mesh 1x1, 2x2
and 4x1 in this one process; every mesh's outputs must be byte-identical
to the 1x1 run, and the 2x2 run must leave arrays on all four cards.

Any failure exits non-zero before the last line, which is the JSON object
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# The realistic workload (muscato_tpu.bench.runner's `big` cell).
NUM_READ = 8_000_000
READ_LEN = 100
NUM_GENE = 100_000
GENE_LEN = 1_000
SEED = 0
SETTINGS = dict(
    Windows=[10, 30, 50, 70], WindowWidth=20, PMatch=0.96, MinDinuc=3,
    MaxReadLength=200, MMTol=2, MaxMatches=1_000_000, MatchMode="best",
    ReadBatch=1 << 23,  # the whole workload in one device batch
)
PARITY_READS = 100_000
OUTPUTS = ("results.txt", "results.nonmatch.txt.fastq",
           "results_readstats.txt", "results_genestats.txt")


class SmokeError(RuntimeError):
    pass


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: ok in {time.perf_counter() - t0:.2f} s", flush=True)


# -------------------------------------------------------------- device ---


def device_phase(min_count: int):
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SmokeError(
            f"JAX's first device is {dev.platform!r}, not a GPU; "
            "this smoke test runs on the card only"
        )
    if len(jax.devices()) < min_count:
        raise SmokeError(
            f"need {min_count} GPUs, JAX sees {len(jax.devices())}"
        )
    from muscato_tpu.bench.runner import card_info
    from muscato_tpu.engine.driver import enable_compile_cache
    from muscato_tpu.io import native

    print(card_info(), flush=True)
    print(f"jax {jax.__version__}, {len(jax.devices())} x {dev.device_kind}, "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, "
          f"compile cache {enable_compile_cache()}", flush=True)
    print(f"native host library loaded: {native.ensure_built() is not None}",
          flush=True)
    return dev


# -------------------------------------------------------------- oracle ---


# (width, mmtol, alphabet, windows): widths on both sides of the exact
# base-5 keys (<= 13), MMTol 0 and 2, and reads and genes carrying X.
ORACLE_CASES = [
    (8, 0, "ACGT", [0, 9]),
    (13, 2, "ACGTX", [0, 5, 14]),
    (16, 2, "ACGT", [3, 20]),
    (20, 0, "ACGTX", [0, 10, 30]),
]


def oracle_phase(seed: int = SEED) -> int:
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from oracle import oracle_match

    from muscato_tpu.config import Config
    from muscato_tpu.engine import pipeline
    from muscato_tpu.io import seqcodec
    from muscato_tpu.io.reads import ReadSet
    from muscato_tpu.io.targets import TargetSet

    total = 0
    for ci, (width, mmtol, alpha, windows) in enumerate(ORACLE_CASES):
        rng = np.random.default_rng((seed, ci))
        letters = np.frombuffer(alpha.encode(), np.uint8)
        genes = [letters[rng.integers(0, len(letters), 160)].tobytes().decode()
                 for _ in range(6)]
        max_rl = max(windows) + width + 20
        reads = []
        for _ in range(60):
            g = genes[int(rng.integers(len(genes)))]
            n = int(rng.integers(max(windows) + width, max_rl + 1))
            a = int(rng.integers(0, len(g) - n + 1))
            frag = bytearray(g[a:a + n].encode())
            for _ in range(int(rng.integers(0, 3))):
                frag[int(rng.integers(n))] = int(letters[rng.integers(len(letters))])
            reads.append(frag.decode())
        reads += [letters[rng.integers(0, len(letters), max_rl)].tobytes().decode()
                  for _ in range(10)]
        cfg = Config(Windows=windows, WindowWidth=width, PMatch=0.9,
                     MinDinuc=1, MaxReadLength=max_rl, MMTol=mmtol,
                     MaxMatches=10**6, MatchMode="best")
        codes, lens = seqcodec.encode_rows([r.encode() for r in reads], max_rl)
        rs = ReadSet(codes=codes, lengths=lens,
                     counts=np.ones(len(reads), np.int64),
                     names=[b"r%d" % i for i in range(len(reads))],
                     num_total=len(reads))
        gene_start = np.cumsum([0] + [len(g) for g in genes]).astype(np.int64)
        ts = TargetSet(
            tcat=np.concatenate([seqcodec.encode(g.encode()) for g in genes]),
            gene_start=gene_start, names=[b"g%d" % i for i in range(6)],
            lengths=np.diff(gene_start),
        )
        mr = pipeline.run_matching(cfg, rs, ts)
        got = set(zip(mr.read_row.tolist(), mr.gene.tolist(),
                      mr.start.tolist(), mr.nmiss.tolist()))
        exp = oracle_match(reads, genes, windows, width, cfg.PMatch,
                           cfg.MinDinuc, max_rl, mmtol)
        if got != exp or not exp:
            raise SmokeError(
                f"oracle case {ci} (width {width}, MMTol {mmtol}, {alpha}): "
                f"{len(got - exp)} rows only on the card, "
                f"{len(exp - got)} only in the oracle, {len(exp)} expected"
            )
        print(f"oracle case {ci}: width {width}, MMTol {mmtol}, {alpha}: "
              f"{len(exp)} rows equal", flush=True)
        total += len(exp)
    return total


# ---------------------------------------------------------------- main ---


def generate_workload(workdir: str, num_read=NUM_READ, num_gene=NUM_GENE,
                      seed=SEED):
    """The realistic workload on disk, and the prepared target files."""
    from muscato_tpu import cli
    from muscato_tpu.bench import gendat
    from muscato_tpu.io import targets

    t0 = time.perf_counter()
    reads_path, genes_path = gendat.generate_big(
        num_read, READ_LEN, num_gene, GENE_LEN, out_dir=workdir, seed=seed)
    print(f"generated {num_read} reads, {num_gene} genes in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    if cli.main_prep_targets([genes_path]) != 0:
        raise SmokeError("muscato_prep_targets failed")
    seq_path, ids_path = targets.prepared_names(genes_path)
    print(f"muscato_prep_targets: {time.perf_counter() - t0:.2f} s",
          flush=True)
    return reads_path, seq_path, ids_path


def workload_genes(num_gene=NUM_GENE, seed=SEED) -> dict:
    """Gene name -> sequence, drawn again from the seed exactly as
    gendat.generate_big draws them (independent of the engine's loaders)."""
    from muscato_tpu.bench import gendat

    rng = np.random.default_rng(seed)
    genes = gendat._BASES[rng.integers(0, 4, size=(num_gene, GENE_LEN))]
    return {b"gene_%d" % i: genes[i].tobytes() for i in range(num_gene)}


def run_muscato(workdir: str, reads_path: str, seq_path: str, ids_path: str,
                mesh: str = "", settings=SETTINGS) -> float:
    """One `muscato` run through the console-script function; outputs land
    in workdir.  Returns the wall time."""
    from muscato_tpu import cli

    os.makedirs(workdir, exist_ok=True)
    cfg = dict(settings, ReadFileName=reads_path, GeneFileName=seq_path,
               GeneIdFileName=ids_path,
               ResultsFileName=os.path.join(workdir, "results.txt"),
               TempDir=os.path.join(workdir, "tmp"),
               LogDir=os.path.join(workdir, "logs"))
    if mesh:
        cfg["Mesh"] = mesh
    cfg_path = os.path.join(workdir, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    t0 = time.perf_counter()
    if cli.main_muscato([f"-ConfigFileName={cfg_path}"]) != 0:
        raise SmokeError(f"muscato failed in {workdir}")
    return time.perf_counter() - t0


def print_stage_logs(workdir: str) -> None:
    """The run's own stage timing lines (prep, index, device stages,
    report), from its log directory."""
    logroot = os.path.join(workdir, "logs")
    (run_id,) = os.listdir(logroot)
    seen = set()
    for name in ("muscato_prep.log", "muscato_index.log",
                 "muscato_screen.log", "muscato_report.log", "muscato.log"):
        path = os.path.join(logroot, run_id, name)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                msg = line.rstrip().split(": ", 1)[-1]
                if msg not in seen:
                    seen.add(msg)
                    print(f"  {name}: {msg}", flush=True)


def check_results(path: str, genes: dict, windows, width: int,
                  pmatch: float, block: int = 1 << 20) -> int:
    """Re-check every row of results.txt against the gene sequences: the
    reported target substring is gene[pos:pos+len], the read's Hamming
    distance to it is nmiss, nmiss is within the budget int((1-PMatch) *
    len), and at least one window matches exactly.  Returns the row
    count; raises SmokeError on the first bad block or on an empty file."""
    names = list(genes)
    gidx = {n: i for i, n in enumerate(names)}
    glen = np.array([len(genes[n]) for n in names], np.int64)
    goff = np.concatenate([[0], np.cumsum(glen)])
    stream = np.frombuffer(b"".join(genes[n] for n in names), np.uint8)
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    if lines and not lines[-1]:
        lines.pop()
    if not lines:
        raise SmokeError(f"{path} has no rows")
    for b0 in range(0, len(lines), block):
        rows = [ln.split(b"\t") for ln in lines[b0:b0 + block]]
        try:
            g = np.array([gidx[r[4]] for r in rows], np.int64)
        except KeyError as e:
            raise SmokeError(f"unknown gene {e} in {path}") from None
        pos = np.array([int(r[2]) for r in rows], np.int64)
        nmiss = np.array([int(r[3]) for r in rows], np.int64)
        rl = np.array([len(r[0]) for r in rows], np.int64)
        lmax = int(rl.max())
        read = np.frombuffer(b"".join(r[0].ljust(lmax, b"\0") for r in rows),
                             np.uint8).reshape(-1, lmax)
        tsub = np.frombuffer(b"".join(r[1].ljust(lmax, b"\0") for r in rows),
                             np.uint8).reshape(-1, lmax)
        if np.any(pos < 0) or np.any(pos + rl > glen[g]):
            raise SmokeError(f"row past its gene's end near row {b0}")
        col = np.arange(lmax)
        live = col[None, :] < rl[:, None]
        at = np.minimum(goff[g][:, None] + pos[:, None] + col[None, :],
                        len(stream) - 1)
        target = np.where(live, stream[at], 0)
        if not np.array_equal(target, tsub):
            raise SmokeError(f"target substring differs from the gene "
                             f"near row {b0}")
        diff = (read != target) & live
        bad = np.flatnonzero(diff.sum(axis=1) != nmiss)
        if len(bad):
            raise SmokeError(f"row {b0 + bad[0]}: nmiss {nmiss[bad[0]]} but "
                             f"Hamming distance {diff[bad[0]].sum()}")
        budget = np.trunc((1.0 - np.float64(pmatch)) * rl).astype(np.int64)
        if np.any(nmiss > budget):
            raise SmokeError(f"nmiss over budget near row {b0}")
        seeded = np.zeros(len(rows), bool)
        for q1 in windows:
            if q1 + width <= lmax:
                seeded |= (rl >= q1 + width) & ~diff[:, q1:q1 + width].any(1)
        if not seeded.all():
            bad = int(np.flatnonzero(~seeded)[0])
            raise SmokeError(f"row {b0 + bad}: no window matches exactly")
    return len(lines)


def report_programs(rec) -> None:
    """Compile seconds and memory_analysis() of each device program a run
    dispatched (bench.dispatches); verify appears twice when the survivor
    buffer regrew.  Raises SmokeError if a stage never ran."""
    missing = {"probe", "expand", "verify", "rank"} - {
        p.stage for p in rec.programs.values()}
    if missing:
        raise SmokeError(f"the run dispatched no {sorted(missing)} program")
    for p in rec.programs.values():
        t0 = time.perf_counter()
        mem = p.memory_analysis()
        static = ", ".join(f"{k}={v}" for k, v in p.kwargs.items())
        print(f"compile {p.stage}: {p.compile_s:.2f} s at first call"
              f"{' (cache hit)' if p.cache_hits else ''}, {p.calls} call(s), "
              f"first argument {p.args[0].shape}, {static}; memory_analysis "
              + ", ".join(f"{k} {v / 2**30:.3f} GiB" for k, v in mem.items())
              + f" (analysed in {time.perf_counter() - t0:.2f} s)",
              flush=True)


def main_phase(workdir: str, num_read=NUM_READ, num_gene=NUM_GENE):
    from muscato_tpu.bench.dispatches import record_dispatches

    with phase("main.generate"):
        paths = generate_workload(workdir, num_read, num_gene)
    run_dir = os.path.join(workdir, "gpu")
    with phase("main.muscato"):
        with record_dispatches() as rec:
            dt = run_muscato(run_dir, *paths)
        print_stage_logs(run_dir)
        print(f"end to end: {dt:.2f} s, {num_read / dt:,.0f} reads/s",
              flush=True)
    with phase("compile"):
        report_programs(rec)
    with phase("main.check"):
        n = check_results(os.path.join(run_dir, "results.txt"),
                          workload_genes(num_gene), SETTINGS["Windows"],
                          SETTINGS["WindowWidth"], SETTINGS["PMatch"])
        print(f"re-checked {n} result rows on the host", flush=True)
    return paths


# -------------------------------------------------------------- parity ---


def head_fastq(src: str, dst: str, nreads: int) -> None:
    with open(src, "rb") as f, open(dst, "wb") as out:
        for _ in range(4 * nreads):
            line = f.readline()
            if not line:
                break
            out.write(line)


def compare_outputs(dir_a: str, dir_b: str) -> None:
    for name in OUTPUTS:
        with open(os.path.join(dir_a, name), "rb") as fa, \
                open(os.path.join(dir_b, name), "rb") as fb:
            a, b = fa.read(), fb.read()
        if a != b:
            raise SmokeError(f"{name} differs between {dir_a} and {dir_b}")
    print(f"byte-identical: {', '.join(OUTPUTS)} "
          f"({os.path.getsize(os.path.join(dir_a, OUTPUTS[0]))} bytes of "
          "results)", flush=True)


def parity_phase(workdir: str, reads_path: str, seq_path: str,
                 ids_path: str, nreads: int = PARITY_READS) -> None:
    sub = os.path.join(workdir, "reads_head.fastq")
    head_fastq(reads_path, sub, nreads)
    cpu_dir = os.path.join(workdir, "parity_cpu")
    gpu_dir = os.path.join(workdir, "parity_gpu")
    code = (
        "import json, sys; from chip_smoke import run_muscato; "
        "a = json.loads(sys.argv[1]); run_muscato(*a)"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    child = subprocess.Popen(
        [sys.executable, "-c", code,
         json.dumps([cpu_dir, sub, seq_path, ids_path])],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    try:
        dt_gpu = run_muscato(gpu_dir, sub, seq_path, ids_path)
        t0 = time.perf_counter()
        out, _ = child.communicate(timeout=900)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        sys.stdout.write(out.decode(errors="replace")[-4000:])
        raise SmokeError(f"CPU muscato run failed ({child.returncode})")
    print(f"device run {dt_gpu:.2f} s; CPU run finished "
          f"{time.perf_counter() - t0:.2f} s after it", flush=True)
    compare_outputs(gpu_dir, cpu_dir)


# ----------------------------------------------------------- four cards ---


def card_peaks(devices) -> list:
    """Peak bytes each device's arrays have held in this process."""
    return [d.memory_stats()["peak_bytes_in_use"] for d in devices]


def mesh_phase(workdir: str, num_read=NUM_READ, num_gene=NUM_GENE) -> None:
    import jax

    with phase("mesh.generate"):
        paths = generate_workload(workdir, num_read, num_gene)
    runs = {}
    for mesh in ("1x1", "2x2", "4x1"):
        with phase(f"mesh.{mesh}"):
            run_dir = os.path.join(workdir, f"mesh_{mesh}")
            dt = run_muscato(run_dir, *paths, mesh=mesh)
            print_stage_logs(run_dir)
            print(f"mesh {mesh}: {dt:.2f} s, {num_read / dt:,.0f} reads/s",
                  flush=True)
            if mesh != "1x1":
                compare_outputs(runs["1x1"], run_dir)
            if mesh == "2x2":
                peaks = card_peaks(jax.devices()[:4])
                print("peak bytes in use per card: "
                      + ", ".join(f"{p / 2**30:.2f} GiB" for p in peaks),
                      flush=True)
                if min(peaks) < (64 << 20):
                    raise SmokeError("the 2x2 mesh left a card idle")
            runs[mesh] = run_dir


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ns = ap.parse_args(argv)
    os.environ["MUSCATO_STAGE_TIMES"] = "1"

    with phase("device"):
        dev = device_phase(ns.cards)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if ns.cards == 4:
            mesh_phase(workdir)
        else:
            with phase("oracle"):
                oracle_phase()
            paths = main_phase(workdir)
            with phase("parity"):
                parity_phase(workdir, *paths)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke failed: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
