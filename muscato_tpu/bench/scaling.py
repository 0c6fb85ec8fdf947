"""Scaling harness: throughput of the sharded matching step vs mesh shape.

BASELINE.md asks for scaling at 1 card / 1 host / N hosts.  Runs over the
visible GPUs, and exits non-zero on a machine without one.

Usage: python -m muscato_tpu.bench.scaling [--NumRead N] [--NumGene N]
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> int:
    from .runner import require_gpu

    require_gpu()
    p = argparse.ArgumentParser()
    p.add_argument("--NumRead", type=int, default=100_000)
    p.add_argument("--NumGene", type=int, default=1_000)
    p.add_argument("--ReadLen", type=int, default=100)
    p.add_argument("--GeneLen", type=int, default=1_000)
    p.add_argument("--Repeats", type=int, default=3)
    ns = p.parse_args(argv)

    import jax

    from muscato_tpu.bench import gendat
    from muscato_tpu.config import Config
    from muscato_tpu.parallel import mesh as pmesh

    cfg = Config(
        Windows=[10, 30, 50, 70], WindowWidth=20, PMatch=0.96, MinDinuc=3,
        MaxReadLength=ns.ReadLen * 2, MMTol=2, MaxMatches=10**6,
        MatchMode="best",
    )
    rs, ts = gendat.generate_arrays(
        ns.NumRead, ns.ReadLen, ns.NumGene, ns.GeneLen, seed=0
    )

    ndev = len(jax.devices())
    shapes = []
    mp = ndev
    while mp >= 1:
        shapes.append((ndev // mp, mp))
        mp //= 2
    shapes = [(d, m) for d, m in shapes if d * m == ndev] or [(1, 1)]

    results = []
    for dp, mp in shapes:
        mesh = pmesh.make_mesh(dp, mp)
        sidx = pmesh.shard_targets(ts, cfg.WindowWidth, mp)
        run = lambda: pmesh.sharded_match_arrays(
            cfg, rs.codes, rs.lengths, sidx, mesh, surv_cap=1 << 15,
        )
        run()  # compile
        best = min(
            (lambda t0: (run(), time.time() - t0)[1])(time.time())
            for _ in range(ns.Repeats)
        )
        results.append(
            {
                "mesh": f"{dp}x{mp}",
                "devices": ndev,
                "reads_per_sec": round(ns.NumRead / best, 1),
            }
        )
        print(json.dumps(results[-1]), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
