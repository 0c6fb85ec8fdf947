"""1x1-mesh vs plain single-device sanity on the realistic workload:
shard_map must add no layout surprises on the card — the mesh timing
should land within ~10% of the plain engine.  GPU only.

Run: python -u -m muscato_tpu.bench.mesh_sanity [--NumRead N] [--NumGene N]
Prints one MESH_SANITY JSON line.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> int:
    from .runner import require_gpu

    require_gpu()
    p = argparse.ArgumentParser()
    p.add_argument("--NumRead", type=int, default=4_000_000)
    p.add_argument("--ReadLen", type=int, default=100)
    p.add_argument("--NumGene", type=int, default=100_000)
    p.add_argument("--GeneLen", type=int, default=1_000)
    p.add_argument("--Repeats", type=int, default=2)
    ns = p.parse_args(argv)

    import jax
    import numpy as np

    from ..config import Config
    from ..engine import pipeline
    from ..engine.index import build_target_index
    from ..parallel import mesh as pmesh
    from . import gendat

    dev = jax.devices()[0]
    print(f"backend={jax.default_backend()} device={dev.device_kind}",
          flush=True)
    cfg = Config(
        Windows=[10, 30, 50, 70], WindowWidth=20, PMatch=0.96, MinDinuc=3,
        MaxReadLength=ns.ReadLen * 2, MMTol=2, MaxMatches=10**6,
        MatchMode="best",
    )
    rs, ts = gendat.generate_arrays_realistic(
        ns.NumRead, ns.ReadLen, ns.NumGene, ns.GeneLen, 0
    )

    # Plain single-device engine.  Compare DEVICE phases: both paths also
    # pay host pack + upload + retained-row fetch, which are not the
    # shard_map question the sanity check exists to answer.
    index = build_target_index(ts, cfg.WindowWidth)
    index.skeys.block_until_ready()
    pipeline.run_matching_indexed(cfg, rs, index)  # compile
    pipeline.preload_device_batch(cfg, rs)

    def plain():
        tm: dict = {}
        pipeline.run_matching_indexed(cfg, rs, index, timings=tm)
        return tm

    t_plain, plain_dev = min(
        (_timed(plain) for _ in range(ns.Repeats)),
        key=lambda x: x[1].get("device_s", x[0]),
    )

    # Same engine under a 1x1 shard_map mesh.
    mesh = pmesh.make_mesh(1, 1)
    sidx = pmesh.shard_targets(ts, cfg.WindowWidth, 1)
    codes, lengths = np.asarray(rs.codes), np.asarray(rs.lengths)

    def run():
        tm: dict = {}
        pmesh.sharded_match_arrays(
            cfg, codes, lengths, sidx, mesh, surv_cap=1 << 20, timings=tm
        )
        return tm

    run()  # compile
    t_mesh, mesh_tm = min(
        (_timed(run) for _ in range(ns.Repeats)),
        key=lambda x: x[1].get("device_s", x[0]),
    )

    out = {
        "device_kind": dev.device_kind,
        "num_read": ns.NumRead,
        "plain_s": round(t_plain, 3),
        "plain_device_s": round(plain_dev.get("device_s", t_plain), 3),
        "mesh_1x1_s": round(t_mesh, 3),
        "mesh_timings": mesh_tm,
        "mesh_over_plain": round(t_mesh / t_plain, 3),
        "mesh_over_plain_device": round(
            mesh_tm.get("device_s", t_mesh)
            / max(plain_dev.get("device_s", t_plain), 1e-9), 3,
        ),
        "dorder": int(_dorder()),
    }
    print("MESH_SANITY " + json.dumps(out), flush=True)
    return 0


def _timed(fn):
    """(wall_s, fn_result); min() keys on wall via the tuple order."""
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def _dorder() -> bool:
    from ..ops import fused

    return fused.dorder_enabled()


if __name__ == "__main__":
    import sys

    sys.exit(main())
