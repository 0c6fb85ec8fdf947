#!/usr/bin/env python
"""Reference-scale single-host demonstration:
100M reads through the FULL muscato driver against a 100M-base target DB.

The reference claims "hundreds of millions of reads and target sequences"
(README.md:4-6 of the reference); this composes every scale feature the
repo built for that claim in ONE run: disk-streamed gendat
(gendat.generate_big), bounded-memory chunked prep (PrepChunk),
IndexFile-cached index, ReadBatch device streaming, and the vectorized
report — recording wall time per stage and the driver process's peak
ANONYMOUS RSS (RssAnon; ru_maxrss counts reclaimable file-backed memmap
pages an idle box never evicts).

Usage:
  python -u scripts/run_100m.py gen   [dir]   # host-only: write the data
  python -u scripts/run_100m.py run   [dir]   # full driver run (on the GPU)
  python -u scripts/run_100m.py both  [dir]
Default dir run100m_out; N reads via N_READS env (default 100_000_000).
Only the driver process opens the card; the helper processes run with
JAX_PLATFORMS=cpu.
Artifacts: dir/run100m.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_READS = int(os.environ.get("N_READS", "100000000"))


def gen(d: str) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.time()
    code = (
        "from muscato_tpu.bench import gendat;"
        f"print(gendat.generate_big({N_READS}, 100, 100000, 1000, "
        f"out_dir={d!r}, seed=7, chunk=10000000, hit_frac=0.5))"
    )
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   cwd=REPO)
    dt = time.time() - t0
    sz = os.path.getsize(os.path.join(d, "reads.fastq"))
    return {"gen_s": round(dt, 1), "fastq_bytes": sz}


def _watch_rss(pid: int, out: dict, stop: threading.Event):
    peak = 0
    path = f"/proc/{pid}/status"
    while not stop.is_set():
        try:
            with open(path) as f:
                for ln in f:
                    if ln.startswith("RssAnon:"):
                        peak = max(peak, int(ln.split()[1]))
                        break
        except OSError:
            break
        stop.wait(0.5)
    out["peak_anon_rss_mb"] = peak // 1024


def run(d: str) -> dict:
    # Stale outputs would silently satisfy the driver's resume checks.
    cfgp = os.path.join(d, "config.json")
    cfg = {
        "ReadFileName": os.path.join(d, "reads.fastq"),
        "GeneFileName": os.path.join(d, "musc_genes.txt.sz"),
        "GeneIdFileName": os.path.join(d, "musc_ids_genes.txt.sz"),
        "ResultsFileName": os.path.join(d, "results.txt"),
        "Windows": [10, 30, 50, 70],
        "WindowWidth": 20,
        "PMatch": 0.96,
        "MinDinuc": 3,
        "MMTol": 2,
        "MaxReadLength": 200,
        "MatchMode": "best",
        "MaxMatches": 1000000,
        "ReadBatch": 1 << 23,
        "PrepChunk": 4000000,
        "IndexFile": os.path.join(d, "index_w20.npz"),
        "TempDir": os.path.join(d, "tmp"),
        "LogDir": os.path.join(d, "logs"),
    }
    rec: dict = {}
    t0 = time.time()
    src = os.path.join(d, "genes.txt.sz")
    done = os.path.join(d, "musc_genes.txt.sz")
    if (os.path.exists(done)
            and os.path.getmtime(done) >= os.path.getmtime(src)):
        rec["prep_targets_s"] = "cached"
    else:
        subprocess.run(
            [sys.executable, "-c",
             "from muscato_tpu.io import targets;"
             f"print(targets.prep_targets({src!r}))"],
            env=dict(os.environ, JAX_PLATFORMS="cpu"), check=True, cwd=REPO,
        )
        rec["prep_targets_s"] = round(time.time() - t0, 1)
    with open(cfgp, "w") as f:
        json.dump(cfg, f)

    env = dict(os.environ, PYTHONUNBUFFERED="1", MUSCATO_STAGE_TIMES="1")
    t0 = time.time()
    p = subprocess.Popen(
        [sys.executable, "-u", "-c",
         "from muscato_tpu import cli;"
         f"cli.main_muscato(['-ConfigFileName={cfgp}'])"],
        env=env, cwd=REPO,
        stdout=open(os.path.join(d, "driver.log"), "wb"),
        stderr=subprocess.STDOUT,
    )
    stop = threading.Event()
    t = threading.Thread(target=_watch_rss, args=(p.pid, rec, stop))
    t.start()
    rcode = p.wait()
    stop.set()
    t.join()
    rec["driver_s"] = round(time.time() - t0, 1)
    rec["driver_exit"] = rcode
    rec["reads_per_sec_end_to_end"] = round(N_READS / rec["driver_s"], 1)
    for nm in ("results.txt",):
        pth = os.path.join(d, nm)
        if os.path.exists(pth):
            rec["result_rows"] = sum(1 for _ in open(pth, "rb"))
    return rec


def main() -> int:
    mode = sys.argv[1] if len(sys.argv) > 1 else "both"
    d = sys.argv[2] if len(sys.argv) > 2 else "run100m_out"
    os.makedirs(d, exist_ok=True)
    outp = os.path.join(d, "run100m.json")
    rec = {}
    if os.path.exists(outp):
        rec = json.load(open(outp))
    rec["n_reads"] = N_READS
    if mode in ("gen", "both"):
        rec.update(gen(d))
        json.dump(rec, open(outp, "w"), indent=1)
    if mode in ("run", "both"):
        rec.update(run(d))
        json.dump(rec, open(outp, "w"), indent=1)
    print(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
