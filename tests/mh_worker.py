"""Multi-host test worker: one OS process of a 2-process CPU 'pod'.

Invoked by tests/test_multihost.py as
    python mh_worker.py <process_id> <num_processes> <port> <outdir>

Each process owns 4 virtual CPU devices; jax.distributed + Gloo provide
the cross-process collectives, so the sharded engine runs exactly the
multi-host code path it would across GPU hosts (global jax.Arrays staged per
process, all_gather over "mp" inside shard_map, process-level merge of
retained rows).  Every process writes its MatchResult so the test can
assert cross-process agreement and parity with the single-device engine.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")


def main():
    pid, nproc, port, outdir = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    )
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.insert(0, os.path.dirname(here))  # repo root: muscato_tpu pkg

    from muscato_tpu.parallel import dist

    dist.initialize(f"localhost:{port}", num_processes=nproc, process_id=pid)
    assert len(jax.devices()) == 4 * nproc

    import numpy as np
    from test_dist import _mk_sets
    from muscato_tpu.config import Config
    from muscato_tpu.parallel import mesh as pmesh

    rng = np.random.default_rng(17)
    width, max_rl = 6, 40
    cfg = Config(
        Windows=[0, 4], WindowWidth=width, PMatch=0.9, MinDinuc=1,
        MaxReadLength=max_rl, MMTol=1, MaxMatches=10**6, MatchMode="best",
    )
    rs, ts = _mk_sets(rng, n_reads=43, n_genes=12, width=width, max_rl=max_rl)

    mesh = dist.pod_mesh(dp=2, mp=4)
    sidx = pmesh.shard_targets(ts, width, 4)
    mr = pmesh.run_matching_sharded(cfg, rs, sidx, mesh)

    assert dist.is_primary() == (pid == 0)

    # Range-sharded multi-host read prep: each process parses a disjoint
    # byte range; the merged ReadSet must equal the single-host build.
    from muscato_tpu.io import reads as reads_io

    fq = os.path.join(outdir, "mh_reads.fastq")
    if pid == 0:
        recs = []
        g = np.random.default_rng(5)
        for i in range(200):
            seq = "".join("ACGT"[c] for c in g.integers(0, 4, 30))
            recs.append(f"@mh{i % 37:03d}\n{seq}\n+\n{'I' * 30}")
        with open(fq, "w") as f:
            f.write("\n".join(recs) + "\n")
    # Both processes need the file; rendezvous via the collective.
    from jax.experimental import multihost_utils as mhu

    mhu.sync_global_devices("mh_fastq_written")
    rs_mh = dist.build_readset_multihost(fq, 0, 40)
    rs_full = reads_io.build_readset(fq, 0, 40)
    np.testing.assert_array_equal(rs_mh.codes, rs_full.codes)
    np.testing.assert_array_equal(rs_mh.counts, rs_full.counts)
    np.testing.assert_array_equal(rs_mh.name_blob, rs_full.name_blob)
    assert rs_mh.num_total == rs_full.num_total
    # The per-process parse really was a slice, not the whole file.
    buf = reads_io._map_bytes(fq)
    bounds = [i * len(buf) // nproc for i in range(nproc + 1)]
    nl = reads_io.count_lines_range(buf, bounds[pid], bounds[pid + 1])
    first = 0 if pid == 0 else len(buf) and sum(
        reads_io.count_lines_range(buf, bounds[p], bounds[p + 1])
        for p in range(pid)
    )
    local = reads_io.build_readset_range(
        buf, 0, 40, bounds[pid], bounds[pid + 1], first
    )
    assert 0 < local.num_total < rs_full.num_total
    np.savez(
        os.path.join(outdir, f"mr_{pid}.npz"),
        read_row=mr.read_row, gene=mr.gene, start=mr.start, nmiss=mr.nmiss,
    )
    print(f"worker {pid} OK: {len(mr.read_row)} matches", flush=True)


if __name__ == "__main__":
    main()
