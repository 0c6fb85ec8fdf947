"""Peak-RSS A/B of the read prep paths.

Measures the one-pass vectorized build_readset against the bounded-memory
build_readset_chunked on the same generated fastq, each in its own
subprocess (clean ru_maxrss), and checks the outputs are byte-identical
via a streaming digest.  The reference analogue of the chunked path is
prep_reads | sort -S 50% | uniqify streaming through disk
(/root/reference/cmd/muscato_prep_reads/main.go:46-92,
cmd/muscato/main.go:181-189).

Usage: python -m muscato_tpu.bench.prep_rss [--NumRead N] [--Chunk N]
Prints one JSON line per mode plus a final comparison line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import subprocess
import sys
import time


def _digest(rs) -> str:
    """Streaming sha256 over the ReadSet's logical content (memmap-safe:
    walks blocks, never materializes a full copy)."""
    import numpy as np

    h = hashlib.sha256()
    for arr in (rs.codes, rs.lengths, rs.counts, rs.name_blob, rs.name_off):
        a = arr if arr.ndim == 1 else arr.reshape(arr.shape[0], -1)
        step = max(1, (1 << 24) // max(1, a[:1].nbytes))
        for i in range(0, a.shape[0], step):
            h.update(np.ascontiguousarray(a[i : i + step]).tobytes())
    h.update(str(rs.num_total).encode())
    return h.hexdigest()[:16]


class _AnonSampler:
    """Max anonymous RSS (RssAnon in /proc/self/status), sampled by a
    thread.  ru_maxrss counts file-backed mmap pages too — on an idle box
    they are never evicted, so it cannot distinguish bounded-anon designs
    (spilled runs + memmap outputs) from fully resident ones.  Anonymous
    pages are the unreclaimable kind that OOM a host; that is the number
    the chunk parameter bounds."""

    def __init__(self):
        import threading

        self.peak = 0.0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _sample(self):
        try:
            with open("/proc/self/status") as f:
                for ln in f:
                    if ln.startswith("RssAnon:"):
                        self.peak = max(self.peak, int(ln.split()[1]) / 1024.0)
        except OSError:
            pass

    def _run(self):
        while not self._stop.wait(0.02):
            self._sample()

    def stop(self) -> float:
        self._stop.set()
        self._t.join()
        self._sample()
        return self.peak


def _child(mode: str, path: str, max_rl: int, chunk: int) -> int:
    from ..io import reads as reads_io

    sampler = _AnonSampler()
    t0 = time.time()
    if mode == "full":
        rs = reads_io.build_readset(path, 0, max_rl)
    else:
        rs = reads_io.build_readset_chunked(path, 0, max_rl, chunk)
    dt = time.time() - t0
    anon_mb = sampler.stop()  # peak during the build, before the digest
    dg = _digest(rs)
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    print(json.dumps({
        "mode": mode, "seconds": round(dt, 2),
        "peak_anon_mb": round(anon_mb, 1),
        "peak_rss_mb": round(rss_mb, 1), "unique": rs.num_unique,
        "total": rs.num_total, "digest": dg,
    }), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--NumRead", type=int, default=10_000_000)
    p.add_argument("--ReadLen", type=int, default=100)
    p.add_argument("--Chunk", type=int, default=1_000_000)
    p.add_argument("--Dir", type=str, default="prep_rss_out")
    p.add_argument("--_mode", type=str, default="")
    p.add_argument("--_path", type=str, default="")
    ns = p.parse_args(argv)

    if ns._mode:
        return _child(ns._mode, ns._path, ns.ReadLen * 2, ns.Chunk)

    from . import gendat

    os.makedirs(ns.Dir, exist_ok=True)
    t0 = time.time()
    reads_path, _ = gendat.generate(
        ns.NumRead, ns.ReadLen, 10, 200, out_dir=ns.Dir
    )
    print(f"# gendat {ns.NumRead} reads: {time.time()-t0:.1f}s", flush=True)

    results = {}
    for mode in ("chunked", "full"):
        r = subprocess.run(
            [sys.executable, "-m", "muscato_tpu.bench.prep_rss",
             "--_mode", mode, "--_path", reads_path,
             "--ReadLen", str(ns.ReadLen), "--Chunk", str(ns.Chunk)],
            capture_output=True, text=True,
            # Host-only children stay off the card: one process per card.
            env=dict(os.environ, JAX_PLATFORMS="cpu"),
        )
        sys.stderr.write(r.stderr[-2000:])
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        rec = json.loads(line[-1]) if line else {"mode": mode, "failed": True}
        results[mode] = rec
        print(json.dumps(rec), flush=True)
    same = (
        "digest" in results.get("full", {})
        and results["full"].get("digest") == results["chunked"].get("digest")
    )
    print(json.dumps({
        "identical": same,
        "anon_ratio": round(
            results["full"].get("peak_anon_mb", 0)
            / max(results["chunked"].get("peak_anon_mb", 1), 1), 2,
        ),
    }), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
