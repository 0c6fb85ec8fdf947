"""Multi-host runtime initialization and mesh construction.

The reference has no distributed runtime (its IPC is Unix pipes,
cmd/muscato/main.go:55-58 in the reference); this module is the entry point
for running the sharded engine (parallel/mesh.py) across several hosts:

  - `initialize()` wires `jax.distributed` from explicit arguments so
    every host sees the global device set; the driver calls it when
    `--Coordinator`/`--ProcessCount` are set (engine/driver.py);
  - `pod_mesh(dp, mp)` builds the 2-D mesh over all global devices, read
    data parallelism over "dp" and gene-range index shards over "mp";
  - every host parses the same inputs (read dedup is global, so each host
    needs the full unique read set) and executes the same global batches;
    parallel/mesh.py stages them as global jax.Arrays
    (make_array_from_callback) so each process feeds only its addressable
    devices, and the retained rows cross hosts once per batch over the
    process collective (mesh._addressable_by_dp + process_allgather);
  - process 0 alone writes the report files.

Single-host multi-card needs no initialize(); `jax.devices()` already
shows the local cards.  The true multi-process path is exercised by
tests/test_multihost.py (2 OS processes x 4 virtual CPU devices, Gloo
collectives); `__graft_entry__.dryrun_multichip` additionally validates
the sharded step on a single-process virtual mesh.
"""

from __future__ import annotations

import jax

from .mesh import make_mesh


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed for a multi-host run.

    A GPU host has no runtime that tells JAX of the cluster, so give the
    coordinator address (host:port), the process count and this
    process's id.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def pod_mesh(dp: int | None = None, mp: int | None = None):
    """A ("dp", "mp") mesh over all global devices.

    Defaults: shard the index over every device (mp = device count,
    dp = 1); pass explicit factors to trade read-parallelism against
    index-shard size (dp * mp must equal the device count used).
    """
    n = len(jax.devices())
    if dp is None and mp is None:
        dp, mp = 1, n
    elif dp is None:
        dp = n // mp
    elif mp is None:
        mp = n // dp
    return make_mesh(dp, mp)


def is_primary() -> bool:
    """True on the process that owns report/file output (the driver skips
    result writing elsewhere; all processes compute identical results)."""
    return jax.process_index() == 0


def build_readset_multihost(read_file: str, min_read_length: int,
                            max_read_length: int):
    """Range-sharded multi-host read prep: each process parses ONLY the
    records whose name line starts inside its byte range of the (decoded)
    read file, dedups locally, and the per-host unique sets are merged
    into the identical global ReadSet on every process.

    Two collectives: a scalar line-count prefix-sum (record ownership)
    and the unique-set exchange.  Per-host prep RAM and sort time shrink
    ~process_count-fold versus every host parsing the full file — the
    DCN analogue of the reference's prep_reads | sort | uniqify merge
    (/root/reference/cmd/muscato/main.go:152-221).  Single-process runs
    short-circuit to the plain builder."""
    import numpy as np

    from ..io import reads as reads_io

    nproc = jax.process_count()
    if nproc == 1:
        return reads_io.build_readset(read_file, min_read_length,
                                      max_read_length)
    from jax.experimental import multihost_utils as mhu

    pid = jax.process_index()
    buf = reads_io._map_bytes(read_file)
    size = len(buf)
    bounds = [i * size // nproc for i in range(nproc + 1)]
    lo, hi = bounds[pid], bounds[pid + 1]
    nlines = reads_io.count_lines_range(buf, lo, hi)
    counts = mhu.process_allgather(np.asarray([nlines], np.int64)).ravel()
    first_line = int(counts[:pid].sum())
    local = reads_io.build_readset_range(
        buf, min_read_length, max_read_length, lo, hi, first_line
    )

    # Exchange per-host unique sets (padded to the global maxima so the
    # allgather shapes agree), then merge identically on every process.
    w = local.codes.shape[1]
    dims = np.asarray(
        [local.num_unique, w, len(local.mem_blob),
         len(local.mem_off) - 1, local.num_total], np.int64
    )
    gdims = mhu.process_allgather(dims)  # (nproc, 5)
    rmax = int(gdims[:, 0].max())
    wmax = int(gdims[:, 1].max())
    bmax = int(gdims[:, 2].max())
    mmax = int(gdims[:, 3].max())

    def pad_to(a, shape, dtype):
        out = np.zeros(shape, dtype)
        sl = tuple(slice(0, s) for s in a.shape)
        out[sl] = a
        return out

    g_codes = mhu.process_allgather(pad_to(local.codes, (rmax, wmax), np.uint8))
    g_len = mhu.process_allgather(pad_to(local.lengths, (rmax,), np.int32))
    g_cnt = mhu.process_allgather(pad_to(local.counts, (rmax,), np.int64))
    g_blob = mhu.process_allgather(pad_to(local.mem_blob, (bmax,), np.uint8))
    g_moff = mhu.process_allgather(
        pad_to(local.mem_off, (mmax + 1,), np.int64)
    )
    g_rmem = mhu.process_allgather(
        pad_to(local.row_mem, (rmax + 1,), np.int64)
    )

    parts = []
    for p in range(nproc):
        r, wp, b, m, nt = (int(x) for x in gdims[p])
        parts.append(reads_io.LocalReads(
            codes=np.asarray(g_codes[p][:r, :wp]),
            lengths=np.asarray(g_len[p][:r]),
            counts=np.asarray(g_cnt[p][:r]),
            num_total=nt,
            mem_blob=np.asarray(g_blob[p][:b]),
            mem_off=np.asarray(g_moff[p][: m + 1]),
            row_mem=np.asarray(g_rmem[p][: r + 1]),
        ))
    return reads_io.merge_local_readsets(parts, max_read_length)
