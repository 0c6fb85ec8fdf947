#!/usr/bin/env python
"""Parallel disk-streamed gendat for the 100M-read run (host-only).

gendat.generate_big is a single sequential RNG stream, slow for a
100M-read fastq (~21GB) on one core.  This splits the
read range into per-worker chunk ranges, each seeded independently as
default_rng((seed, chunk_index)) — the data is equally realistic, just
not bit-identical to the sequential stream — and concatenates the part
files in order.  The genes array (and genes.txt.sz) is the SAME
deterministic seed-7 draw as generate_big, so hit density and the
target DB are unchanged.

Usage: python -u scripts/gen_parallel.py [dir] [n_reads] [workers]
Every worker runs with JAX_PLATFORMS=cpu: none of them needs the card.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CHUNK = int(os.environ.get("GEN_CHUNK", "10000000"))


def worker(out_dir: str, w: int, c_lo: int, c_hi: int, n_reads: int) -> None:
    import numpy as np

    from muscato_tpu.bench import gendat

    num_gene, gene_len, read_len, hit_frac, sub_rate = (
        100_000, 1_000, 100, 0.5, 0.02)
    rng0 = np.random.default_rng(7)
    genes = gendat._BASES[rng0.integers(0, 4, size=(num_gene, gene_len))]
    max_off = max(gene_len - read_len, 1)
    part = os.path.join(out_dir, f"reads.part{w:02d}")
    with open(part + ".tmp", "wb") as f:
        for ci in range(c_lo, c_hi):
            c0 = ci * CHUNK
            n = min(CHUNK, n_reads - c0)
            if n <= 0:
                break
            rng = np.random.default_rng((7, ci))
            nhit = int(n * hit_frac)
            g = rng.integers(0, num_gene, nhit).astype(np.int32)
            o = rng.integers(0, max_off, nhit).astype(np.int32)
            cols = o[:, None] + np.arange(read_len, dtype=np.int32)[None, :]
            mat = np.empty((n, read_len), np.uint8)
            mat[:nhit] = genes[g[:, None], np.minimum(cols, gene_len - 1)]
            sub = rng.random((nhit, read_len)) < sub_rate
            mat[:nhit][sub] = gendat._BASES[rng.integers(0, 4, int(sub.sum()))]
            mat[nhit:] = gendat._BASES[
                rng.integers(0, 4, (n - nhit, read_len))]
            f.write(gendat._fastq_blob(mat, c0).tobytes())
            print(f"w{w} chunk {ci} done", flush=True)
    os.replace(part + ".tmp", part)


def main() -> int:
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "run100m_out"
    n_reads = int(sys.argv[2]) if len(sys.argv) > 2 else 100_000_000
    nw = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    if len(sys.argv) > 4 and sys.argv[4] == "--worker":
        worker(out_dir, int(sys.argv[5]), int(sys.argv[6]),
               int(sys.argv[7]), n_reads)
        return 0

    os.makedirs(out_dir, exist_ok=True)
    nchunks = (n_reads + CHUNK - 1) // CHUNK
    per = (nchunks + nw - 1) // nw
    t0 = time.time()

    if not os.path.exists(os.path.join(out_dir, "genes.txt.sz")):
        from muscato_tpu.bench import gendat
        import numpy as np
        rng0 = np.random.default_rng(7)
        genes = gendat._BASES[rng0.integers(0, 4, size=(100_000, 1_000))]
        gendat._genes_file(genes, out_dir)
        print("genes.txt.sz written", flush=True)

    procs = []
    for w in range(nw):
        c_lo, c_hi = w * per, min((w + 1) * per, nchunks)
        if c_lo >= c_hi:
            continue
        p = subprocess.Popen(
            [sys.executable, "-u", __file__, out_dir, str(n_reads),
             str(nw), "--worker", str(w), str(c_lo), str(c_hi)],
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        procs.append((w, p))
    rc = 0
    for w, p in procs:
        rc |= p.wait()
    if rc:
        print(f"worker failure rc={rc}", flush=True)
        return rc

    dst = os.path.join(out_dir, "reads.fastq")
    with open(dst + ".tmp", "wb") as out:
        for w, _ in procs:
            part = os.path.join(out_dir, f"reads.part{w:02d}")
            with open(part, "rb") as f:
                shutil.copyfileobj(f, out, 64 << 20)
            os.unlink(part)
    os.replace(dst + ".tmp", dst)
    sz = os.path.getsize(dst)
    print(f"done: {sz} bytes in {time.time()-t0:.0f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
