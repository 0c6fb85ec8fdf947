"""Multi-chip execution: gene-range-sharded index, data-parallel reads.

The reference has no distributed capability at all — its parallelism is
goroutines + OS processes on one host (SURVEY.md section 2.4).  This module
spreads the engine over several devices:

  - a 2-D jax.sharding.Mesh ("dp", "mp"): read batches are sharded over
    "dp" (data parallelism), the target index is sharded by contiguous gene
    ranges over "mp" (model/state parallelism);
  - each device probes its read shard against its index shard and verifies
    locally (shard_map);
  - per-device survivor lists (fixed capacity + count) are merged with
    lax.all_gather over the "mp" axis ONLY — reads are disjoint across
    "dp", so the downstream read-keyed stages (MaxMatches cap, dedup,
    best+MMTol) never need cross-dp traffic.  This is the collective
    replacement for the reference's `sort | join` file merges
    (/root/reference/cmd/muscato/main.go:454-476, 657-670); the round-1
    all_gather over *both* axes was O(dp*mp) per device and is gone;
  - the host fetches per-(dp, mp) survivor *prefixes* only (counts are
    returned alongside), so fetch traffic is proportional to real
    survivors, not to buffer capacity;
  - the host applies the same deterministic cap/dedup/rank stages as the
    single-chip path — including the (key1, key2) MaxMatches group columns,
    which the survivor rows carry — so N-device output is bit-identical to
    1-device output.

Capacity handling: survivor buffers are statically sized; per-device
survivor counts are returned, and run_matching_sharded regrows capacity
and re-runs a batch on overflow exactly like the single-chip driver loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..io.targets import TargetSet
from ..ops import fused
from ..ops import packed as pops
from ..ops import verify as vops
from .. import config as config_mod
from ..engine.index import _index_arrays


@dataclass
class ShardedIndex:
    """Per-shard padded index arrays; leading axis = mp shard."""

    gene_start: jnp.ndarray  # (mp, Gmax+1) int32, local offsets (pads repeat the end)
    skeys: jnp.ndarray  # (mp, Vmax) uint32, INVALID_KEY padded
    spos: jnp.ndarray  # (mp, Vmax) int32, -1 padded
    tpacked: jnp.ndarray  # (mp, SWmax+PAD) uint32 nibble-packed shard streams
    gene_base: jnp.ndarray  # (mp,) int32 first global gene id of the shard
    width: int
    num_shards: int
    smax: int  # padded per-shard stream length in bases

    def verify_aux(self, nwords: int):
        """Per-shard row-gather view + gene block tables (stacked along the
        shard axis), built lazily per read width and cached — the mesh
        analogue of TargetIndex.trows()/gene_block() (engine/index.py).
        Returns (trows (mp, nrows, nwords+9) uint32,
                 gblock (mp, nb) int32, gsteps)."""
        cache = getattr(self, "_aux_cache", None)
        if cache is not None and cache[0] == nwords:
            return cache[1]
        rowlen = nwords + pops.TROWS_GUARD
        nrows = pops.trows_nrows(self.smax)
        need = 8 * (nrows - 1) + rowlen
        tp = np.asarray(self.tpacked)
        if tp.shape[1] < need:
            tp = np.pad(tp, ((0, 0), (0, need - tp.shape[1])))
        # Overlapping strided view per shard: rows[i] = tp[8i : 8i+rowlen].
        sv = np.lib.stride_tricks.as_strided(
            tp, (tp.shape[0], nrows, rowlen),
            (tp.strides[0], 8 * tp.strides[1], tp.strides[1]),
        )
        trows = jnp.asarray(np.ascontiguousarray(sv))
        gs_np = np.asarray(self.gene_start)
        gbs, steps = [], 1
        for si in range(self.num_shards):
            gb, st = pops.build_gene_block(gs_np[si], self.smax)
            gbs.append(gb)
            steps = max(steps, st)
        aux = (trows, jnp.asarray(np.stack(gbs)), steps)
        self._aux_cache = (nwords, aux)
        return aux


def shard_targets(ts: TargetSet, width: int, num_shards: int) -> ShardedIndex:
    """Split genes into contiguous ranges with roughly equal base counts,
    build each shard's index, and pad to a common shape.

    Stream padding past a shard's real bases can never produce index
    entries: window validity requires the window to end before the shard's
    real length (engine.index._index_arrays nreal argument), so runs of
    non-ACGT read bases cannot match the padding."""
    g = ts.num_genes
    sizes = np.diff(ts.gene_start)
    total = int(ts.gene_start[-1])
    bounds = [0]
    acc = 0
    per = total / num_shards if num_shards else total
    for i in range(g):
        acc += int(sizes[i])
        if acc >= per * len(bounds) and len(bounds) < num_shards:
            bounds.append(i + 1)
    while len(bounds) < num_shards:
        bounds.append(g)
    bounds.append(g)

    shards = []
    for si in range(num_shards):
        lo, hi = bounds[si], bounds[si + 1]
        start = int(ts.gene_start[lo])
        end = int(ts.gene_start[hi])
        tcat = np.asarray(ts.tcat[start:end], dtype=np.uint8)
        gs = (np.asarray(ts.gene_start[lo : hi + 1]) - start).astype(np.int32)
        shards.append((tcat, gs, lo))

    smax = max((len(t) for t, _, _ in shards), default=width)
    smax = max(smax, width)
    gmax = max((len(gs) - 1 for _, gs, _ in shards), default=1)
    gmax = max(gmax, 1)

    tcat_p = np.full((num_shards, smax), 4, dtype=np.uint8)  # X padding
    gene_start_p = np.zeros((num_shards, gmax + 1), dtype=np.int32)
    gene_base = np.zeros(num_shards, dtype=np.int32)
    skeys_l: List[np.ndarray] = []
    spos_l: List[np.ndarray] = []
    tpacked_l: List[np.ndarray] = []

    for si, (tcat, gs, lo) in enumerate(shards):
        s = len(tcat)
        tcat_p[si, :s] = tcat
        ng = len(gs) - 1
        gene_start_p[si, : ng + 1] = gs
        gene_start_p[si, ng + 1 :] = gs[-1]
        gene_base[si] = lo
        skeys, _skeys2, spos, _nvalid = _index_arrays(
            jnp.asarray(tcat_p[si]), jnp.asarray(gene_start_p[si]),
            jnp.int32(s), width,
        )
        skeys_l.append(np.asarray(skeys))
        spos_l.append(np.asarray(spos))
        tpacked_l.append(np.asarray(pops.pack_stream(tcat_p[si])))

    return ShardedIndex(
        gene_start=jnp.asarray(gene_start_p),
        skeys=jnp.asarray(np.stack(skeys_l)),
        spos=jnp.asarray(np.stack(spos_l)),
        tpacked=jnp.asarray(np.stack(tpacked_l)),
        gene_base=jnp.asarray(gene_base),
        width=width,
        num_shards=num_shards,
        smax=smax,
    )


def make_mesh(dp: int, mp: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if dp * mp > len(devices):
        raise ValueError(f"mesh {dp}x{mp} needs {dp*mp} devices, have {len(devices)}")
    dev = np.asarray(devices[: dp * mp]).reshape(dp, mp)
    return Mesh(dev, axis_names=("dp", "mp"))


def _globalize_inputs(mesh: Mesh, specs, arrays):
    """Multi-host input staging: host values must become global jax.Arrays
    (a plain numpy arg would be replicated per-process and shard_map would
    see inconsistent global shapes).  Every host holds the same full
    logical value (same target files, same read batch), so each process
    serves its addressable shards by slicing its local copy."""
    out = []
    for a, spec in zip(arrays, specs):
        a = np.asarray(a)
        sh = jax.sharding.NamedSharding(mesh, spec)
        out.append(
            jax.make_array_from_callback(a.shape, sh, lambda idx, _a=a: _a[idx])
        )
    return tuple(out)


def _addressable_by_dp(arr, dp: int, axis0_size: int):
    """Map a P('dp')-sharded output's addressable shards to {dp row:
    numpy block} (mp-replicated duplicates collapse by index)."""
    per = axis0_size // dp
    out = {}
    for sh in arr.addressable_shards:
        sl = sh.index[0]
        d0 = (sl.start or 0) // per
        if d0 not in out:
            out[d0] = np.asarray(sh.data)
    return out


def _probe_step(rpacked, lengths, skeys, q1s, *, width, min_dinuc):
    """Stage 1 per-device body: probe the local read block against the
    local index shard (sort-merge join, the same probe as the single-chip
    path).  Emits the compacted slot arrays plus the exact pair total;
    the host fetches only the (dp, mp) totals to size the expand stage's
    pair buffer exactly, mirroring engine.pipeline's probe-first flow."""
    counts, lo, qid, _kf, _k2, total, totalf = fused._probe_windows_impl(
        rpacked, lengths, q1s, skeys[0], width=width, min_dinuc=min_dinuc,
    )
    # keyf/key2f are read-only functions of the dp block; stage 2
    # recomputes them (one packed extraction) instead of carrying two
    # nflat-sized operands through device memory between the stages.
    return (
        counts[None, None], lo[None, None], qid[None, None],
        total[None, None], totalf[None, None],
    )


def _rank_gathered(buf, nsurv, totalf, gene_base, mm, mmtol, *, surv_cap,
                   match_mode):
    """Globalize gene ids, all_gather survivors along "mp" only (reads are
    disjoint across "dp", so read-keyed downstream stages need no dp
    traffic), and rank the gathered buffer ON DEVICE (cap + dedup +
    best+MMTol: every row of a dp-block's reads is present after the mp
    gather) so the host fetches retained rows only."""
    live = jnp.arange(surv_cap, dtype=jnp.int32) < nsurv
    buf = buf.at[:, 1].add(jnp.where(live, gene_base, 0))
    buf = jnp.where(live[:, None], buf, -1)

    surv = jax.lax.all_gather(buf, "mp", axis=0)  # (mp, surv_cap, NCOL)
    nsurv_all = jax.lax.all_gather(nsurv, "mp", axis=0)  # (mp,)
    totalf_all = jax.lax.all_gather(totalf, "mp", axis=0)  # (mp,)

    mp = surv.shape[0]
    flat = surv.reshape(mp * surv_cap, surv.shape[-1])
    off = jnp.arange(mp * surv_cap, dtype=jnp.int32)
    live_flat = (off % surv_cap) < nsurv_all[off // surv_cap]
    rows, count = fused._rank_survivors_live_impl(
        flat, live_flat, mm, mmtol, match_mode=match_mode
    )
    return rows[None], count[None], nsurv_all[None], totalf_all[None]


def _verify_step_dedup(
    counts, lo, qid, rpacked, lengths, gene_start, spos, tpacked, trows,
    gblock, gene_base, budget, q1s, *, width, min_dinuc, max_read_length,
    pair_cap, vchunk, surv_cap, smax, gsteps, mm, mmtol, match_mode, dorder,
):
    """Stage 2 per-device body (diagonal-dedup engine): the SAME expand +
    verify the single-chip path runs (fused._expand_pairs_impl /
    _verify_diagonals_impl with the row-gather trows view and the gene
    block table), then the mp merge + on-device rank."""
    counts, lo, qid = counts[0, 0], lo[0, 0], qid[0, 0]
    gene_start, spos, tpacked = gene_start[0], spos[0], tpacked[0]
    trows, gblock, gene_base = trows[0], gblock[0], gene_base[0]
    nreads = rpacked.shape[0]
    keyf, key2f, _valid = fused._window_queries(
        rpacked, lengths, q1s, width=width, min_dinuc=min_dinuc
    )
    qid_s, u_idx, ur, ud, nuniq, _total, totalf = fused._expand_pairs_impl(
        counts, lo, qid, q1s, spos, nreads=nreads, pair_cap=pair_cap,
        dorder=dorder, smax=smax, max_read_length=max_read_length,
    )
    surv, nsurv = fused._verify_diagonals_impl(
        qid_s, u_idx, ur, ud, nuniq, keyf, key2f, q1s, rpacked, lengths,
        tpacked, gene_start, budget, trows, gblock,
        nreads=nreads, width=width, max_read_length=max_read_length,
        vchunk=vchunk, surv_cap=surv_cap, smax=smax, gsteps=gsteps,
    )
    return _rank_gathered(surv, nsurv, totalf, gene_base, mm, mmtol,
                          surv_cap=surv_cap, match_mode=match_mode)


def _verify_step_streamed(
    counts, lo, qid, rpacked, lengths, gene_start, spos, tpacked, trows,
    gblock, gene_base, budget, q1s, *, width, min_dinuc, max_read_length,
    pair_chunk, surv_cap, smax, gsteps, mm, mmtol, match_mode,
):
    """Stage 2 per-device body (streaming engine): O(pair_chunk) memory for
    batches whose pair count exceeds the dedup materialization ceiling —
    the same fallback policy as the single-chip loop."""
    counts, lo, qid = counts[0, 0], lo[0, 0], qid[0, 0]
    gene_start, spos, tpacked = gene_start[0], spos[0], tpacked[0]
    trows, gblock, gene_base = trows[0], gblock[0], gene_base[0]
    keyf, key2f, _valid = fused._window_queries(
        rpacked, lengths, q1s, width=width, min_dinuc=min_dinuc
    )
    surv, nsurv, _total, totalf = fused._expand_verify_impl(
        counts, lo, qid, keyf, key2f, q1s, rpacked, lengths, spos,
        tpacked, gene_start, budget, trows, gblock,
        nreads=rpacked.shape[0], width=width,
        max_read_length=max_read_length,
        pair_chunk=pair_chunk, surv_cap=surv_cap, smax=smax, gsteps=gsteps,
    )
    return _rank_gathered(surv, nsurv, totalf, gene_base, mm, mmtol,
                          surv_cap=surv_cap, match_mode=match_mode)


_JIT_CACHE: dict = {}


def _mesh_key(mesh: Mesh):
    """Stable cache identity for a mesh: shape + device ids (id(mesh) can
    be recycled after GC; two meshes over the same devices and axes yield
    equivalent executables)."""
    return (
        tuple(mesh.shape.items()),
        tuple(d.id for d in np.asarray(mesh.devices).flat),
    )


def _cached_mapped(key, make):
    """jit(shard_map(...)) executables keyed by their static parameters —
    a fresh partial per call would retrace every batch."""
    fn = _JIT_CACHE.get(key)
    if fn is None:
        fn = jax.jit(make())
        _JIT_CACHE[key] = fn
    return fn


def _global_minmax(arr) -> tuple[float, float]:
    """(min, max) of a (dp, mp) device scalar grid, multi-host safe: each
    process reduces its addressable shards, then one process_allgather
    merges — every process sees the same values (lockstep decisions)."""
    vals = [np.asarray(sh.data) for sh in arr.addressable_shards]
    lo = min((float(v.min()) for v in vals), default=0.0)
    hi = max((float(v.max()) for v in vals), default=0.0)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils as mhu

        g = mhu.process_allgather(np.asarray([lo, hi]))
        lo, hi = float(np.min(g[..., 0])), float(np.max(g[..., 1]))
    return lo, hi


# Sequence numbers for the gather-to-primary KV keys: every process
# calls the merge in lockstep (it follows mesh collectives), so a plain
# counter yields matching tags without any extra coordination.
import itertools as _itertools  # noqa: E402

_GATHER_SEQ = _itertools.count()
_KV_CHUNK = 48 << 20  # bytes per KV value (stay well under gRPC limits)


def _gather_rows_to_primary(local: "np.ndarray", ncol: int):
    """Ship this process's retained rows to the primary over the
    jax.distributed KV store; returns the concatenated global rows on the
    primary and None elsewhere.

    Replaces the symmetric process_allgather merge: only the primary
    ranks and writes results (run_matching_sharded), so shipping every
    retained row to every process was nproc x wasted DCN traffic and
    per-host RAM in the tail.  With this path
    non-primary receive volume in the merge is zero."""
    import os as _os

    from jax._src import distributed

    client = distributed.global_state.client
    nproc = jax.process_count()
    pid = jax.process_index()
    if client is None or nproc == 1:
        return local
    timeout_ms = int(_os.environ.get("MUSCATO_MERGE_TIMEOUT_MS", "600000"))
    tag = f"muscato/gather/{next(_GATHER_SEQ)}"
    local = np.ascontiguousarray(local, dtype=np.int32)
    if pid != 0:
        data = local.tobytes()
        nchunks = -(-len(data) // _KV_CHUNK)  # 0 chunks for an empty set
        client.key_value_set(f"{tag}/{pid}/n", f"{len(data)}:{nchunks}")
        for i in range(nchunks):
            client.key_value_set_bytes(
                f"{tag}/{pid}/{i}", data[i * _KV_CHUNK : (i + 1) * _KV_CHUNK]
            )
        # The barrier keeps the KV keys alive until the primary has read
        # them and keeps batch iterations in lockstep.
        client.wait_at_barrier(f"{tag}/done", timeout_ms)
        return None
    parts = [local]
    for p in range(1, nproc):
        meta = client.blocking_key_value_get(f"{tag}/{p}/n", timeout_ms)
        nbytes, nchunks = (int(x) for x in meta.split(":"))
        buf = b"".join(
            client.blocking_key_value_get_bytes(f"{tag}/{p}/{i}", timeout_ms)
            for i in range(nchunks)
        )
        assert len(buf) == nbytes, (len(buf), nbytes)
        parts.append(np.frombuffer(buf, np.int32).reshape(-1, ncol))
        client.key_value_delete(f"{tag}/{p}/n")
        for i in range(nchunks):
            client.key_value_delete(f"{tag}/{p}/{i}")
    client.wait_at_barrier(f"{tag}/done", timeout_ms)
    return np.concatenate(parts)


# Mirrors engine.pipeline's dedup-path sizing policy (same constants).
from ..engine.pipeline import (  # noqa: E402
    _MAX_PAIR_CAP, _PAIR_FLOOR, _bucket_ceil,
)

import logging as _logging  # noqa: E402

logger = _logging.getLogger("muscato.pipeline")


def sharded_match_arrays(
    cfg: config_mod.Config,
    codes: np.ndarray,
    lengths: np.ndarray,
    sidx: ShardedIndex,
    mesh: Mesh,
    surv_cap: int = 1 << 14,
    timings: dict | None = None,
):
    """Run the probe+verify stage over the mesh — the same two-phase flow
    as the single-chip engine (probe first; its pair totals size the
    expand stage exactly), with the index shard axis mapped over "mp" and
    read blocks over "dp".

    Returns ((r, g, s, nx, grp, grp2, window) numpy arrays of retained
    candidate matches with read rows globalized, surv_cap) — surv_cap is
    the (possibly regrown) capacity so the caller can persist the hint.
    Survivor overflow regrows and re-runs stage 2 in place (the probe is
    reused); ValueError on expansion-counter overflow."""
    dp = mesh.shape["dp"]
    mp = mesh.shape["mp"]
    r_total = codes.shape[0]
    pad = (-r_total) % dp
    if pad:
        codes = np.concatenate([codes, np.zeros((pad, codes.shape[1]), codes.dtype)])
        lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])

    import time as _time

    t0 = _time.perf_counter()
    budget = jnp.asarray(vops.mismatch_budget_table(cfg.PMatch, cfg.MaxReadLength))
    q1s = jnp.asarray(np.asarray(cfg.Windows, dtype=np.int32))
    rpacked = pops.pack_rows_np(codes)
    if timings is not None:
        timings["pack_s"] = round(_time.perf_counter() - t0, 4)
    nwords = rpacked.shape[1]
    trows, gblock, gsteps = sidx.verify_aux(nwords)
    multi = jax.process_count() > 1

    probe_in = (P("dp", None), P("dp"), P("mp", None), P())
    slot_spec = P("dp", "mp", None)
    probe_out = (slot_spec,) * 3 + (P("dp", "mp"),) * 2

    verify_in = (
        slot_spec, slot_spec, slot_spec,  # counts, lo, qid (stay on device)
        P("dp", None),  # rpacked
        P("dp"),  # lengths
        P("mp", None),  # gene_start
        P("mp", None),  # spos
        P("mp", None),  # tpacked
        P("mp", None, None),  # trows
        P("mp", None),  # gblock
        P("mp"),  # gene_base
        P(),  # budget
        P(),  # q1s
    )
    verify_out = (P("dp"),) * 4

    if multi:
        # The index side is globalized once per (index, mesh, width) and
        # cached; only the per-batch read arrays cross the host->device
        # boundary each call.
        ckey = (_mesh_key(mesh), nwords, cfg.PMatch, cfg.MaxReadLength,
                tuple(cfg.Windows))
        cache = getattr(sidx, "_global_cache", None)
        if cache is None or cache[0] != ckey:
            fixed = _globalize_inputs(
                mesh,
                (P("mp", None), P("mp", None), P("mp", None),
                 P("mp", None, None), P("mp", None), P("mp"), P(), P()),
                (sidx.gene_start, sidx.spos, sidx.tpacked, trows, gblock,
                 sidx.gene_base, budget, q1s),
            )
            skeys_g = _globalize_inputs(mesh, (P("mp", None),), (sidx.skeys,))[0]
            cache = (ckey, fixed, skeys_g)
            sidx._global_cache = cache
        _, fixed, skeys_g = cache
        rp_g, len_g = _globalize_inputs(
            mesh, (P("dp", None), P("dp")), (rpacked, lengths)
        )
        q1s_g = fixed[7]
    else:
        fixed = (sidx.gene_start, sidx.spos, sidx.tpacked, trows, gblock,
                 sidx.gene_base, budget, q1s)
        skeys_g, q1s_g = sidx.skeys, q1s
        # Explicit dp-sharded placement for the read arrays: without it
        # each shard_map call (and every capacity retry) re-uploads the
        # host matrix.
        sh = jax.sharding.NamedSharding(mesh, P("dp", None))
        rp_g = jax.device_put(rpacked, sh)
        len_g = jax.device_put(
            lengths, jax.sharding.NamedSharding(mesh, P("dp"))
        )

    # ---- Stage 1: probe ----
    if timings is not None:
        # Single-process mode passes host arrays straight into shard_map
        # (upload then happens inside the first mapped call and lands in
        # device_s); multi-host globalizes first and is split here.
        for a in (rp_g, len_g):
            if hasattr(a, "block_until_ready"):
                a.block_until_ready()
        timings["upload_s"] = round(_time.perf_counter() - t0, 4)
        t0 = _time.perf_counter()
    pkey = ("probe", _mesh_key(mesh), cfg.WindowWidth, cfg.MinDinuc)
    mapped_probe = _cached_mapped(pkey, lambda: jax.shard_map(
        partial(_probe_step, width=cfg.WindowWidth, min_dinuc=cfg.MinDinuc),
        mesh=mesh, in_specs=probe_in, out_specs=probe_out,
        check_vma=False,
    ))
    counts, lo, qid, total_d, totalf_d = mapped_probe(
        rp_g, len_g, skeys_g, q1s_g
    )
    # Check the float pair total: an int32-wrapped total must raise,
    # never size a buffer.
    _, tfmax = _global_minmax(totalf_d)
    if tfmax > float(2**30):
        raise ValueError(
            "candidate pair count on one device exceeds the 2**30 "
            "expansion limit; re-run with a smaller ReadBatch"
        )
    _, tmax = _global_minmax(total_d)

    max_total = int(tmax)
    use_dedup = (
        len(cfg.Windows) <= 31 and not cfg.NoDedup
        and max_total <= _MAX_PAIR_CAP
    )
    vchunk = cfg.MaxPairChunk or (1 << 20)
    pair_chunk = cfg.MaxPairChunk or (1 << 17)

    # ---- Stage 2: expand + verify + mp-merge + on-device rank ----
    while True:
        if use_dedup:
            pair_cap = max(_PAIR_FLOOR, _bucket_ceil(max_total))
            statics = dict(
                width=cfg.WindowWidth, min_dinuc=cfg.MinDinuc,
                max_read_length=cfg.MaxReadLength,
                pair_cap=pair_cap, vchunk=min(vchunk, pair_cap),
                surv_cap=surv_cap, smax=sidx.smax, gsteps=gsteps,
                mm=cfg.MaxMatches, mmtol=cfg.MMTol,
                match_mode=cfg.MatchMode, dorder=fused.dorder_enabled(),
            )
            vkey = ("vdedup", _mesh_key(mesh)) + tuple(sorted(statics.items()))
            step = _verify_step_dedup
        else:
            statics = dict(
                width=cfg.WindowWidth, min_dinuc=cfg.MinDinuc,
                max_read_length=cfg.MaxReadLength,
                pair_chunk=pair_chunk, surv_cap=surv_cap, smax=sidx.smax,
                gsteps=gsteps, mm=cfg.MaxMatches, mmtol=cfg.MMTol,
                match_mode=cfg.MatchMode,
            )
            vkey = ("vstream", _mesh_key(mesh)) + tuple(sorted(statics.items()))
            step = _verify_step_streamed
        mapped_verify = _cached_mapped(vkey, lambda: jax.shard_map(
            partial(step, **statics),
            mesh=mesh, in_specs=verify_in, out_specs=verify_out,
            check_vma=False,
        ))
        rows_d, count_d, nsurv, totalf = mapped_verify(
            counts, lo, qid, rp_g, len_g, *fixed
        )
        _, ns_max = _global_minmax(nsurv)
        if int(ns_max) > surv_cap:
            # Exact pow2 bucket over the known need (same policy as the
            # single-chip loop); the probe result is reused.
            surv_cap = max(surv_cap * 2, _bucket_ceil(int(ns_max)))
            logger.info("mesh: survivor capacity regrown to %d", surv_cap)
            continue
        break

    if timings is not None:
        count_d.block_until_ready()
        timings["device_s"] = round(_time.perf_counter() - t0, 4)
        t0 = _time.perf_counter()
    per = codes.shape[0] // dp
    if multi:
        # Multi-host merge: each process fetches its addressable dp blocks
        # only, then the retained rows cross hosts ONCE, to the primary
        # (the only process that ranks and writes; run_matching_sharded).
        counts_np = _addressable_by_dp(count_d, dp, dp)
        blocks = _addressable_by_dp(rows_d, dp, dp)
        out = []
        for d, block in sorted(blocks.items()):
            n = int(counts_np[d][0])
            if not n:
                continue
            rows = np.array(block[0, :n])
            rows[:, 0] += d * per  # local read row -> global row
            out.append(rows)
        local = (
            np.concatenate(out)
            if out
            else np.zeros((0, fused.NCOL), dtype=np.int32)
        )
        local = local[(local[:, 0] >= 0) & (local[:, 0] < r_total)]
        z = _gather_rows_to_primary(local, fused.NCOL)
        if z is None:  # non-primary: nothing to return, nothing received
            z = np.zeros((0, fused.NCOL), dtype=np.int32)
        return tuple(z[:, i].astype(np.int32) for i in range(fused.NCOL)), surv_cap

    # Fetch only the retained-row prefixes (ranked on device): traffic
    # tracks real matches, not dp*mp*capacity.
    counts_np = np.asarray(count_d)  # (dp,)
    out = []
    for d in range(dp):
        n = int(counts_np[d])
        if not n:
            continue
        rows = np.array(rows_d[d, :n])
        rows[:, 0] += d * per  # local read row -> global row
        out.append(rows)
    if not out:
        z = np.zeros((0, fused.NCOL), dtype=np.int32)
    else:
        z = np.concatenate(out)
    z = z[(z[:, 0] >= 0) & (z[:, 0] < r_total)]
    if timings is not None:
        timings["fetch_s"] = round(_time.perf_counter() - t0, 4)
    return tuple(z[:, i].astype(np.int32) for i in range(fused.NCOL)), surv_cap


# Process-wide survivor-capacity hint for the mesh path (the analogue of
# engine.pipeline._CAP_HINT): regrows persist across batches and runs so
# right-sized executables are reused.
_CAP_HINT = [1 << 14]


def run_matching_sharded(cfg, rs, sidx: ShardedIndex, mesh: Mesh):
    """Full sharded matching: stream read batches over the mesh (survivor
    capacity regrows in place and persists process-wide), then apply the
    same deterministic cap/dedup/rank stages as the single-chip path.

    Mirrors engine.pipeline.run_matching_indexed batch-for-batch; output is
    bit-identical to the single-chip engine.  On multi-host pods only the
    primary process runs the host-side cap/dedup/rank (the work grows with
    host-count x match-count and its result is only written by the
    primary, engine/driver.py); non-primary processes return an empty
    MatchResult."""
    from ..engine import pipeline as pl

    dp = mesh.shape["dp"]
    nreads = rs.codes.shape[0]
    batch = cfg.ReadBatch or (1 << 22)
    batch = min(batch, pl._round_up(nreads, 1024 * dp))
    batch = pl._round_up(batch, dp)

    for k, q1 in enumerate(cfg.Windows):
        if not pl._window_has_reads(rs, q1, cfg.WindowWidth, cfg.MinDinuc):
            raise SystemExit(f"Window {k} produced no valid reads, exiting")

    import time as _time

    surv_cap = max(_CAP_HINT[0], 1 << 14)
    all_rows = []
    for b0 in range(0, nreads, batch):
        t_batch = _time.perf_counter()
        b1 = min(b0 + batch, nreads)
        codes = np.asarray(rs.codes[b0:b1])
        lengths = np.asarray(rs.lengths[b0:b1])
        cols, surv_cap = sharded_match_arrays(
            cfg, codes, lengths, sidx, mesh, surv_cap=surv_cap
        )
        _CAP_HINT[0] = surv_cap
        rows = np.stack(cols, axis=1)
        rows[:, 0] += b0
        all_rows.append(rows)
        dt = _time.perf_counter() - t_batch
        logger.info(
            "mesh batch reads [%d,%d): %d survivors, %.2fs (%.0f reads/s)",
            b0, b1, len(rows), dt, (b1 - b0) / max(dt, 1e-9),
        )

    z = np.zeros(0, dtype=np.int32)
    if jax.process_count() > 1 and jax.process_index() != 0:
        # Rank once, on the primary: every process holds the identical
        # global row set after the merge, so N-1 identical host rank
        # passes would be pure duplicated work (it grows with total
        # matches).
        logger.info("non-primary process: rank deferred to the primary")
        return pl.MatchResult(z, z, z, z)
    if not all_rows or not sum(len(x) for x in all_rows):
        return pl.MatchResult(z, z, z, z)
    rows = np.concatenate(all_rows)
    r, g, s, nx, grp, grp2, win = (rows[:, i] for i in range(fused.NCOL))
    r, g, s, nx = pl._apply_max_matches(cfg, r, g, s, nx, grp, grp2, win)
    return pl._dedup_and_rank(cfg, r, g, s, nx)
