"""End-to-end matching pipeline (single process, device compute).

Replaces the reference's 13-stage process pipeline
(/root/reference/cmd/muscato/main.go:1005-1058) with one driver around
device kernels:

  window_reads+screen+sort+confirm  -> per-window probe + verify
  combine_filter|sort -u            -> exact dedup on (read, gene, start)
  combine_windows                   -> per-read best+MMTol filter

The per-(window, k-mer-group) MaxMatches cap of muscato_confirm
(main.go:236-242, 424-448) is applied between verify and dedup.  Where the
reference's cap is racy (goroutine emit order decides survivors), this
implementation is deterministic: 'best' keeps the MaxMatches lowest-nmiss
pairs with (nmiss, gene, pos, read) tie-breaking; 'first' keeps the cap in
canonical (read, gene, pos) order.  Outputs are identical whenever the cap
does not bind (the golden tests keep MaxMatches >> group sizes; see
SURVEY.md section 4 on the reference's nondeterminism there).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..io.reads import ReadSet
from ..io.targets import TargetSet
from ..ops import fused
from ..ops import packed as packed_ops
from ..ops import verify as vops
from .index import TargetIndex, build_target_index

logger = logging.getLogger("muscato.pipeline")


@dataclass
class MatchResult:
    """Final retained matches, one entry per (unique read x gene x start)."""

    read_row: np.ndarray  # int32, row into the ReadSet
    gene: np.ndarray  # int32, row into the TargetSet
    start: np.ndarray  # int32, read start within the gene (reported pos)
    nmiss: np.ndarray  # int32


def _round_up(n: int, to: int) -> int:
    return max(to, -(-n // to) * to)


# Process-wide survivor-capacity hint: overflow regrows persist across
# batches and runs so right-sized executables are reused.
_CAP_HINT = [1 << 16]

# Pair-buffer floor for the diagonal-dedup expand path (capacity is sized
# exactly per batch from the probe's pair total, bucketed to powers of two
# to bound executable counts), and the ceiling beyond which a batch falls
# back to the streaming expand+verify (the dedup path materializes every
# candidate pair; extreme low-entropy batches would blow HBM, the
# streaming path handles them in O(chunk)).
_PAIR_FLOOR = 1 << 18
_MAX_PAIR_CAP = 1 << 26


def _pow2ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _bucket_ceil(n: int) -> int:
    """Smallest p * 2^k >= n with p in {5,6,7,8}: quarter-pow2 capacity
    buckets.  Power-of-two sizing overshoots by up to 2x, and the pair
    sort plus every dense expansion pass scales with the buffer, not
    with the live prefix; quarter buckets cap the overshoot at 25% while
    keeping the set of distinct executables bounded (a fixed batch size
    produces totals that land in the same bucket run after run).  For
    n >= 8192 the result is automatically 1024-aligned."""
    n = max(int(n), 8)
    k = max((n - 1).bit_length() - 3, 0)
    return ((n + (1 << k) - 1) >> k) << k


def _window_has_reads(rs: ReadSet, q1: int, width: int, min_dinuc: int) -> bool:
    """The reference's per-window abort counts reads passing the *length*
    gate only (cmd/muscato_window_reads/main.go:108-112 increments before
    the entropy check)."""
    return bool(np.any(rs.lengths >= q1 + width))



def _probe_totals(pr) -> tuple[int, float]:
    """One blocking fetch for the probe's (total, totalf) scalars instead
    of two separate int()/float() syncs."""
    a, b = jax.device_get((pr[5], pr[6]))
    return int(a), float(b)


def run_matching(
    cfg: Config,
    rs: ReadSet,
    ts: TargetSet,
    index: TargetIndex | None = None,
) -> MatchResult:
    if index is None:
        if int(ts.gene_start[-1]) > np.iinfo(np.int32).max:
            # Databases past the int32 position limit run as sequential
            # gene-range shards on one device (a multi-device run shards
            # them across "mp" instead, engine.driver._choose_mesh).
            nsh = int(-(-int(ts.gene_start[-1]) // (3 << 29)))
            return run_matching_gene_sharded(cfg, rs, ts, nsh)
        index = build_target_index(ts, cfg.WindowWidth)
    return run_matching_indexed(cfg, rs, index)


def run_matching_gene_sharded(
    cfg: Config, rs: ReadSet, ts: TargetSet, nshards: int
) -> MatchResult:
    """Sequential gene-range sharding on one device: build and probe one
    contiguous gene-range index at a time, then run the usual cap/dedup/
    rank over the union.  Handles databases larger than 2**31 positions
    (and bounds index HBM) without a multi-device mesh; results are
    identical to a single-index run because candidate sets are disjoint
    across gene ranges."""
    bounds = np.searchsorted(
        np.asarray(ts.gene_start),
        np.linspace(0, int(ts.gene_start[-1]), nshards + 1),
    ).astype(np.int64)
    bounds[0], bounds[-1] = 0, ts.num_genes
    parts = []
    for si in range(nshards):
        lo, hi = int(bounds[si]), int(bounds[si + 1])
        if hi <= lo:
            continue
        start = int(ts.gene_start[lo])
        end = int(ts.gene_start[hi])
        sub = TargetSet(
            tcat=np.asarray(ts.tcat[start:end]),
            gene_start=np.asarray(ts.gene_start[lo : hi + 1]) - start,
            names=list(ts.names[lo:hi]),
            lengths=np.asarray(ts.lengths[lo:hi]),
        )
        index = build_target_index(sub, cfg.WindowWidth)
        rows = run_matching_indexed(cfg, rs, index, _defer_rank=True)
        rows[:, 1] += lo
        parts.append(rows)
        logger.info(
            "gene shard %d/%d (genes [%d,%d)): %d survivors",
            si + 1, nshards, lo, hi, len(rows),
        )
    if not parts or not sum(len(p) for p in parts):
        z = np.zeros(0, dtype=np.int32)
        return MatchResult(z, z, z, z)
    rows = np.concatenate(parts)
    r, g, s, nx, grp, grp2, win = (rows[:, i] for i in range(fused.NCOL))
    r, g, s, nx = _apply_max_matches(cfg, r, g, s, nx, grp, grp2, win)
    return _dedup_and_rank(cfg, r, g, s, nx)


def run_matching_indexed(
    cfg: Config, rs: ReadSet, index: TargetIndex, probe: str | None = None,
    _defer_rank: bool = False, timings: dict | None = None,
):
    """probe: None = auto-select, 'sort' = sort-merge join, 'search' =
    bucketed search probe (direct or binary per the index's SearchAux).
    _defer_rank returns the raw (N, NCOL) survivor rows instead of the
    ranked MatchResult (gene-range sharding unions shards first).
    timings, when given, receives {'device_s', 'fetch_s', 'fetch_bytes'}:
    the batch-loop wall time (device compute, synced per batch by the
    scalar survivor-count fetch) vs the bulk retained-row device->host
    copy."""
    width = cfg.WindowWidth
    # Trim the packed read matrix to the longest actual read — verify
    # gather cost is linear in the packed word count.
    l_eff = int(max(int(rs.lengths.max(initial=0)), width))
    l_eff = min(l_eff, rs.codes.shape[1]) or rs.codes.shape[1]
    budget = jnp.asarray(vops.mismatch_budget_table(cfg.PMatch, cfg.MaxReadLength))

    pair_chunk = cfg.MaxPairChunk or (1 << 17)
    # The dedup verify's while-loop body is cheap per lane (one row gather
    # + SWAR), so each iteration takes many lanes: 1<<20 lanes keeps the
    # transient SWAR buffers ~100-400MB.  MUSCATO_VCHUNK overrides it
    # (larger chunks trade device-memory transients for fewer
    # iterations).
    vchunk = cfg.MaxPairChunk or int(
        os.environ.get("MUSCATO_VCHUNK", str(1 << 20))
    )
    q1s = jnp.asarray(np.asarray(cfg.Windows, dtype=np.int32))

    # The reference aborts when a window seeds no reads
    # (cmd/muscato_window_reads/main.go:143-151).
    for k, q1 in enumerate(cfg.Windows):
        if not _window_has_reads(rs, q1, width, cfg.MinDinuc):
            raise SystemExit(f"Window {k} produced no valid reads, exiting")

    # Unique reads stream through the resident index in fixed-size batches,
    # so the read collection never has to fit in HBM at once (the batch is
    # padded to a few power-of-two shapes to bound recompilation).
    nreads = rs.codes.shape[0]
    batch = cfg.ReadBatch or (1 << 22)
    batch = min(batch, _round_up(nreads, 1024))

    # Probe strategy: sort-merge re-sorts the whole index per batch (best
    # when V is comparable to the batch's K*R queries); the bucketed search
    # touches only the queried entries (best for a huge resident index
    # probed by a small batch).  The sort-merge join pays ~(V + Q) sorted
    # rows per batch, the search probe dependent gather rounds per query;
    # the crossover is set at V > 64*Q.
    nflat = len(cfg.Windows) * min(batch, _round_up(nreads, 1024))
    if probe is None:
        use_search = index.skeys.shape[0] > 64 * nflat
    else:
        use_search = probe == "search"
    index_aux = index.search_aux() if use_search else None

    import time as _time

    # Row-gather verify inputs: the overlapping target-row view and the
    # gene block table (built once per run; see ops.packed.build_trows).
    trows = index.trows(packed_ops.packed_width(l_eff))
    gblock, gsteps = index.gene_block()

    # MUSCATO_STAGE_TIMES=1: per-batch stage breakdown riding the loop's
    # existing scalar syncs (each stage's blocking count fetch is a true
    # barrier for that stage's device work) — near-zero cost.
    stage_times = os.environ.get("MUSCATO_STAGE_TIMES") == "1"
    st_sums = {"host_stage": 0.0, "probe": 0.0, "expand_verify": 0.0,
               "rank": 0.0}

    t_run0 = _time.perf_counter()
    surv_rows = []
    total_pairs = 0
    nbatches = -(-nreads // batch)
    surv_cap = max(_CAP_HINT[0], 1 << 16)
    # Single-batch retained rows are fetched 64-bit-packed (8 bytes/match
    # instead of 16) when (read, gene, start, nmiss) fit: field widths are
    # derived from the batch size, gene count, longest gene, and the
    # mismatch-budget maximum.  The multi-batch path re-caps across
    # batches and needs the group columns, so it stays unpacked.
    pack_bits = None
    if not (_defer_rank or nbatches > 1):
        pack_bits = _fetch_pack_bits(index, batch, cfg)
        if pack_bits is not None and sum(pack_bits) > 64:
            pack_bits = None
    def _dispatch_probe(rpacked, lengths):
        return fused.probe_windows(
            rpacked, lengths, q1s, index.skeys,
            width=width, min_dinuc=cfg.MinDinuc, index_aux=index_aux,
        )

    # Cross-batch pipelining: batch N+1's probe is DISPATCHED before any
    # of batch N's blocking fetches, so the device runs probe(N+1) while
    # the host sits in batch N's scalar round trips and its expand/rank
    # dispatch gaps.  Costs one extra batch of probe buffers in device
    # memory; MUSCATO_PREFETCH_PROBE=0 disables it.
    prefetch_probe = os.environ.get("MUSCATO_PREFETCH_PROBE", "1") == "1"
    next_dev = _device_read_batch(
        rs, 0, batch, l_eff, cache_ok=(nreads <= batch)
    )
    pr_next = None
    for b0 in range(0, nreads, batch):
        t_batch = _time.perf_counter()
        b1 = min(b0 + batch, nreads)
        rpacked, lengths = next_dev
        # Probe first; its exact pair total (one scalar fetch that
        # overlaps nothing the host needs sooner) sizes the dedup pair
        # buffer exactly — no overflow/regrow re-dispatches.
        pr = pr_next if pr_next is not None else _dispatch_probe(
            rpacked, lengths
        )
        pr_next = None
        # Stage batch N+1's host matrix + upload NOW, while batch N's
        # probe executes (the total fetch below would otherwise
        # serialize host staging against device compute; device_put is
        # async, so the copy rides alongside the probe), then queue its
        # probe behind batch N's.
        st_host = 0.0
        if b0 + batch < nreads:
            t_hs = _time.perf_counter()
            next_dev = _device_read_batch(
                rs, b0 + batch, b0 + 2 * batch, l_eff, cache_ok=False
            )
            if prefetch_probe:
                pr_next = _dispatch_probe(*next_dev)
            st_host = _time.perf_counter() - t_hs
        total, totalf = _probe_totals(pr)
        t_probe_done = _time.perf_counter()
        if totalf > float(2**30):
            # The expansion offsets are int32 cumsums; beyond ~2**30
            # candidate pairs per batch they would wrap.  This only
            # happens with extremely repetitive/low-entropy batches —
            # re-run with a smaller ReadBatch (the error is loud, never
            # a silent wrap).
            raise ValueError(
                f"candidate pair count {totalf:.3g} in one read "
                "batch exceeds the 2**30 expansion limit; re-run with a "
                "smaller ReadBatch (or raise MinDinuc)"
            )
        # Diagonal-dedup expand path: verify each (read, diagonal) once
        # across all windows.  Streaming path for >31 windows (the
        # verdict bitmask is an int32) or when the batch's pair count
        # exceeds the materialization ceiling.
        use_dedup = (
            len(cfg.Windows) <= 31 and not cfg.NoDedup
            and total <= _MAX_PAIR_CAP
        )
        while True:
            if use_dedup:
                pair_cap = max(_PAIR_FLOOR, _bucket_ceil(total))
                buf, nsurv_d, _t, _tf = fused.expand_verify_dedup(
                    pr, q1s, rpacked, lengths, index.spos,
                    index.tpacked, index.gene_start, budget,
                    width=width, max_read_length=cfg.MaxReadLength,
                    pair_cap=pair_cap, vchunk=min(vchunk, pair_cap),
                    surv_cap=surv_cap, smax=index.num_bases,
                    trows=trows, gblock=gblock, gsteps=gsteps,
                )
            else:
                buf, nsurv_d, _t, _tf = fused.expand_verify_streamed(
                    pr, q1s, rpacked, lengths, index.spos,
                    index.tpacked, index.gene_start, budget,
                    width=width, max_read_length=cfg.MaxReadLength,
                    pair_chunk=pair_chunk, surv_cap=surv_cap,
                    smax=index.num_bases,
                    trows=trows, gblock=gblock, gsteps=gsteps,
                )
            nsurv = int(nsurv_d)
            if nsurv <= surv_cap:
                break
            # Overflow: grow to the exact bucket covering the now-known
            # survivor count and re-run the expand stage (the probe result
            # is reused).  Tight sizing matters: the verify compaction and
            # the whole rank stage scale with surv_cap, so a 4x-overshoot
            # bucket taxes every later batch.  The grown capacity persists
            # process-wide so later runs and batches start right-sized.
            surv_cap = max(surv_cap * 2, _bucket_ceil(nsurv))
            _CAP_HINT[0] = surv_cap
        t_ev_done = _time.perf_counter()
        total_pairs += total
        if nsurv:
            # Cap + dedup + best+MMTol run on device; the host fetches the
            # retained rows only (at realistic hit density the raw
            # survivor buffer is several times larger).
            rows_dev, count_d = fused.rank_survivors(
                buf, nsurv_d, cfg.MaxMatches, cfg.MMTol,
                match_mode=cfg.MatchMode, surv_cap=surv_cap,
                full_cols=(_defer_rank or nbatches > 1),
                pack_bits=pack_bits,
            )
            count = int(count_d)
            # Defer the row fetch: the device slice is queued now, the
            # host copy happens after the loop, overlapping later batches'
            # device compute (device->host latency is a per-batch cost).
            surv_rows.append((rows_dev[: _round_up(count, 1024)], count, b0))
        t_rank_done = _time.perf_counter()
        dt = t_rank_done - t_batch
        if stage_times:
            sb = {
                "host_stage": st_host,
                "probe": t_probe_done - t_batch - st_host,
                "expand_verify": t_ev_done - t_probe_done,
                "rank": t_rank_done - t_ev_done,
            }
            for k, v in sb.items():
                st_sums[k] += v
            logger.info(
                "stage times [%d,%d): host_stage=%.3f probe=%.3f "
                "expand_verify=%.3f rank=%.3f total=%.3f",
                b0, b1, sb["host_stage"], sb["probe"],
                sb["expand_verify"], sb["rank"], dt,
            )
        # Heartbeat per batch (the reference logs every 1e5-1e6 records,
        # cmd/muscato_screen/main.go:167-169, 442-444; a batch is this
        # engine's unit of progress).
        logger.info(
            "batch reads [%d,%d): %d pairs, %d survivors, %d retained, "
            "%.2fs (%.0f reads/s)",
            b0, b1, int(total), nsurv, surv_rows[-1][1] if nsurv else 0,
            dt, (b1 - b0) / max(dt, 1e-9),
        )

    if stage_times:
        logger.info(
            "stage sums over %d batches: host_stage=%.3f probe=%.3f "
            "expand_verify=%.3f rank=%.3f",
            nbatches, st_sums["host_stage"], st_sums["probe"],
            st_sums["expand_verify"], st_sums["rank"],
        )
        if timings is not None:
            timings["stages"] = {k: round(v, 4) for k, v in st_sums.items()}
    if timings is not None:
        # All device work is dispatched and (but for the final row slices)
        # synced by the per-batch scalar count fetches above.
        timings["device_s"] = _time.perf_counter() - t_run0
        timings["fetch_bytes"] = sum(
            rd.size * 4 for rd, _c, _ in surv_rows
        )
        t_fetch0 = _time.perf_counter()
    fetched = []
    for rows_dev, count, b0 in surv_rows:
        rows = np.array(rows_dev)[:count]
        if pack_bits is not None:
            rows = _unpack_rows64(rows, pack_bits)
        rows[:, 0] += b0  # batch-local read row -> global row
        fetched.append(rows)
    surv_rows = fetched
    if timings is not None:
        timings["fetch_s"] = _time.perf_counter() - t_fetch0

    logger.info(
        "windows %s: %d candidate pairs, %d retained",
        cfg.Windows, total_pairs, sum(len(x) for x in surv_rows),
    )

    if _defer_rank:
        if not surv_rows:
            return np.zeros((0, fused.NCOL), dtype=np.int32)
        return np.concatenate(surv_rows)

    if not surv_rows:
        z = np.zeros(0, dtype=np.int32)
        return MatchResult(z, z, z, z)

    rows = np.concatenate(surv_rows)
    if nbatches == 1:
        # Single batch: the device pipeline already produced the final
        # retained set in canonical (read, gene, start) order.
        return MatchResult(
            rows[:, 0].copy(), rows[:, 1].copy(),
            rows[:, 2].copy(), rows[:, 3].copy(),
        )
    # Multiple batches: k-mer cap groups span batches, so re-apply the cap
    # (a group's global top-MaxMatches is a subset of the union of its
    # per-batch top-MaxMatches) and re-rank; both passes are idempotent on
    # already-filtered rows.
    r, g, s, nx, grp, grp2, win = (rows[:, i] for i in range(fused.NCOL))
    r, g, s, nx = _apply_max_matches(cfg, r, g, s, nx, grp, grp2, win)
    return _dedup_and_rank(cfg, r, g, s, nx)


def _fetch_pack_bits(index: TargetIndex, batch: int, cfg: Config):
    """Static bit widths (rbits, gbits, sbits, xbits) for the 64-bit packed
    retained-row fetch, or None when the fields cannot fit.  All bounds are
    known before dispatch: read rows are batch-local, gene ids index the
    TargetSet, start offsets are bounded by the longest gene, and nmiss is
    bounded by the mismatch-budget maximum."""
    maxg = getattr(index, "_max_gene_len", None)
    if maxg is None:
        gs = np.asarray(index.gene_start)
        maxg = int(np.max(np.diff(gs))) if len(gs) > 1 else 1
        index._max_gene_len = maxg
    ngenes = int(index.gene_start.shape[0]) - 1
    bmax = int(
        vops.mismatch_budget_table(cfg.PMatch, cfg.MaxReadLength).max()
    )
    rb = max(1, (batch - 1).bit_length())
    gb = max(1, (max(ngenes, 1) - 1).bit_length() or 1)
    sb = max(1, maxg.bit_length())
    xb = max(1, bmax.bit_length())
    bits = (rb, gb, sb, xb)
    return bits if sum(bits) <= 64 else None


def _unpack_rows64(rows: np.ndarray, pack_bits) -> np.ndarray:
    """Host-side inverse of ops.fused._pack_rows64: (n, 2) int32 lo/hi
    words -> (n, 4) int32 (read, gene, start, nmiss) rows."""
    rb, gb, sb, xb = pack_bits
    u = rows[:, 0].astype(np.uint32).astype(np.uint64) | (
        rows[:, 1].astype(np.uint32).astype(np.uint64) << np.uint64(32)
    )
    out = np.empty((len(rows), 4), dtype=np.int32)
    for col, b in ((3, xb), (2, sb), (1, gb), (0, rb)):
        out[:, col] = (u & np.uint64((1 << b) - 1)).astype(np.int32)
        u >>= np.uint64(b)
    return out


def preload_device_batch(cfg: Config, rs: ReadSet) -> None:
    """Stage a single-batch ReadSet's device arrays ahead of time (cached
    on the ReadSet).  Benchmarks use this to move host->device transfer
    out of the timed region."""
    width = cfg.WindowWidth
    l_eff = int(max(int(rs.lengths.max(initial=0)), width))
    l_eff = min(l_eff, rs.codes.shape[1]) or rs.codes.shape[1]
    nreads = rs.codes.shape[0]
    batch = cfg.ReadBatch or (1 << 22)
    batch = min(batch, _round_up(nreads, 1024))
    if nreads <= batch:
        _device_read_batch(rs, 0, batch, l_eff, cache_ok=True)


def _device_read_batch(rs: ReadSet, b0: int, b1: int, l_eff: int, cache_ok: bool):
    """Device arrays (rpacked, lengths) for read rows [b0, b1), padded to
    the batch size.  Only the nibble-packed matrix ships and lives on
    device — the probe extracts window keys from the packed words and the
    verify is SWAR over them, so the unpacked byte matrix never exists
    on device.

    Single-batch runs cache the upload on the ReadSet (benchmark loops);
    multi-batch streaming never caches — resident read memory stays one
    batch regardless of collection size."""
    cache = getattr(rs, "_dev_cache", None)
    key = (b0, b1, l_eff)
    if cache is not None and key in cache:
        return cache[key]
    n = b1 - b0
    nreads = rs.codes.shape[0]
    nw = packed_ops.packed_width(l_eff)
    # Multi-batch streaming: pack the WHOLE collection once (host cache)
    # and slice per batch, so the numpy pack does not run synchronously
    # inside the batch loop; the one-time pass costs the same total but
    # amortizes across batches and reps.  Gated by host-memory budget
    # (4 bytes x nw per read).
    pall = getattr(rs, "_packed_all", None)
    if pall is not None and pall[0] != l_eff:
        pall = None
    if pall is None and nreads > n:
        budget = float(_os_env_gb("MUSCATO_PACK_ALL_GB", 8.0)) * (1 << 30)
        if nreads * nw * 4 <= budget:
            pall = (l_eff, packed_ops.pack_rows_all_np(rs.codes, l_eff))
            rs._packed_all = pall
    if pall is not None:
        packed_np = np.zeros((n, nw), dtype=np.uint32)
        real_n = min(b1, nreads) - b0
        packed_np[:real_n] = pall[1][b0 : b0 + real_n]
    else:
        codes_np = np.zeros((n, l_eff), dtype=np.uint8)
        real = rs.codes[b0:b1, :l_eff]
        real_n = real.shape[0]
        codes_np[:real_n] = real
        packed_np = packed_ops.pack_rows_np(codes_np)
    lengths_np = np.zeros(n, dtype=np.int32)
    lengths_np[:real_n] = rs.lengths[b0 : b0 + real_n]
    rpacked = jnp.asarray(packed_np)
    lengths = jnp.asarray(lengths_np)
    if cache_ok:
        if cache is None:
            cache = {}
            rs._dev_cache = cache
        cache[key] = (rpacked, lengths)
    return rpacked, lengths


def _os_env_gb(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _apply_max_matches(cfg, r, g, s, nx, grp, grp2, win):
    """Per-(window, k-mer group) cap on emitted matches
    (cmd/muscato_confirm/main.go:236-242).  The group identity is the full
    (key1, key2) pair so wide-window key1 collisions cannot merge two
    distinct k-mer groups.

    In 'first' mode the reference appends a match and only then checks
    len(qvals) > MaxMatches (main.go:236-238), so it emits up to
    MaxMatches+1 rows per group — reproduced here with rank < mm+1."""
    mm = cfg.MaxMatches
    if cfg.MatchMode == "first":
        order_cols = (r, s, g, grp2, grp, win)
    else:
        order_cols = (r, s, g, nx, grp2, grp, win)
    order = np.lexsort(order_cols)  # last key is primary: (window, group)-major
    w_s, grp_s, grp2_s = win[order], grp[order], grp2[order]
    # rank within (window, group)
    newgrp = np.concatenate(
        [[True],
         (w_s[1:] != w_s[:-1]) | (grp_s[1:] != grp_s[:-1])
         | (grp2_s[1:] != grp2_s[:-1])]
    )
    grp_ix = np.cumsum(newgrp) - 1
    first_of_grp = np.flatnonzero(newgrp)
    rank = np.arange(len(grp_s)) - first_of_grp[grp_ix]
    cap = mm + 1 if cfg.MatchMode == "first" else mm
    keep = rank < cap
    kept = order[keep]
    return r[kept], g[kept], s[kept], nx[kept]


def _dedup_and_rank(cfg, r, g, s, nx):
    """Exact dedup on (read, gene, start) then per-read best+MMTol filter
    (combine_filter + sort -u + combine_windows,
    /root/reference/cmd/muscato/main.go:422-505)."""
    order = np.lexsort((s, g, r))
    r, g, s, nx = r[order], g[order], s[order], nx[order]
    if len(r):
        first = np.concatenate(
            [[True], (r[1:] != r[:-1]) | (g[1:] != g[:-1]) | (s[1:] != s[:-1])]
        )
        r, g, s, nx = r[first], g[first], s[first], nx[first]

    if len(r):
        # Per-read minimum nmiss over the deduped set.
        read_first = np.concatenate([[True], r[1:] != r[:-1]])
        seg = np.cumsum(read_first) - 1
        best = np.full(seg[-1] + 1, np.iinfo(np.int32).max, dtype=np.int64)
        np.minimum.at(best, seg, nx)
        keep = nx <= best[seg] + cfg.MMTol
        r, g, s, nx = r[keep], g[keep], s[keep], nx[keep]

    return MatchResult(r, g, s, nx)
