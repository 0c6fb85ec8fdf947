"""Fused matching kernels: probe and expand/verify, two device dispatches.

The matching stage runs as two jitted programs with no host round trip
between them (results flow device-to-device):

  probe_windows    window extraction + entropy gate + sort-merge join of
                   read window keys against the target-window index
  expand_verify    chunked pair expansion + SWAR verification + on-device
                   compaction into one survivor buffer

Probe design — a *sort-merge join*, not a per-query binary search.  One
sort of the (V + Q) keys replaces log2(V) dependent gathers per query.
The join is:

  1. concatenate index key1s with query key1s (payload encodes row class)
     and stable-sort by key1 alone — index entries precede the queries
     that equal them; key2 never rides the sort (hash collisions between
     distinct wide k-mers only add candidates the byte-true verify
     rejects);
  2. ie[j] = number of index entries before merged position j (a cumsum),
     L[j] = ie at the start of j's equal-key segment (a cummax over
     segment starts — valid because ie is nondecreasing);
  3. for a valid query at j: its candidate run in the index is
     [L[j], L[j] + (ie[j] - L[j])) — counts fall out positionally, with
     no lookups and no run-length table.

One sort + one cumsum + one cummax replaces every per-query search gather.
Pair expansion then walks the merged order directly (the downstream
dedup/rank canonicalizes order, so queries are never un-sorted).  For a
small batch against a huge index the bucketed search probes below touch
only the queried entries instead.

Other design points:

  - probe and expand/verify are separate programs: the host reads the
    probe's exact pair total and sizes the pair buffer before dispatching
    the expansion;
  - window offsets arrive as a traced (K,) vector over a flattened (K*R,)
    query space — one executable serves any K-window run;
  - the entropy gate counts distinct dinucleotides with a 25-bit
    presence-mask + popcount (utils.CountDinuc semantics,
    utils/entropy.go:5-40 in the reference);
  - pairs are expanded in fixed-size chunks inside a device while_loop
    (dynamic trip count) and verified by the SWAR kernel (ops/packed.py)
    with a per-lane window offset;
  - survivors are compacted on device by prefix-sum scatter into one
    (surv_cap, 6) buffer of rows (read, gene, start, nmiss, group, window);
    the host fetches the count and the filled prefix only;
  - capacity overflow is reported, never silently truncated — the caller
    re-runs with a larger bucket.

`group` is the read's (key1, key2) window key pair bit-cast to two int32
columns — the identity of the reference's per-k-mer group for the
MaxMatches cap (cmd/muscato_confirm/main.go:171-250 processes one k-mer
group per searchpairs call).  Both words participate so wide-window hash
collisions on key1 alone cannot merge two distinct k-mer groups.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
from jax import lax

from . import packed as pops
from . import search as sops
from . import windows as winops

NCOL = 7  # r, g, s, nx, group1, group2, window


# Diagonal-major dedup verify (MUSCATO_DORDER=1): sort the pair buffer by
# (diagonal, read) instead of (read, diagonal).  The unique-(r, d) set and
# every downstream contract are unchanged; what changes is which verify
# fetch stream walks in order.  In (r, d) order the READ rows are
# sequential and the TARGET row gather (the trows view, the largest table
# the engine touches) is random; in (d, r) order the target stream is
# sequential and the random side moves to the smaller read matrix.
_DORDER = [os.environ.get("MUSCATO_DORDER", "0") == "1"]


def dorder_enabled() -> bool:
    return _DORDER[0]


def set_dorder(on: bool) -> None:
    _DORDER[0] = on


_jit_cache = {}


def _jit(fn, static):
    key = fn.__name__
    if key not in _jit_cache:
        _jit_cache[key] = jax.jit(fn, static_argnames=static)
    return _jit_cache[key]


def _horner(win: jnp.ndarray, mult) -> jnp.ndarray:
    """Fold the last axis into a key with multiplier `mult`."""
    key = jnp.zeros(win.shape[:-1], dtype=jnp.uint32)
    for i in range(win.shape[-1]):
        key = key * mult + win[..., i]
    return key


def _window_queries_codes(codes, lengths, q1s, *, width, min_dinuc):
    """Byte-matrix twin of _window_queries: a (K, R, W) element gather
    over the code matrix.  Kept as the readable reference the tests
    compare the packed extraction against."""
    nreads, lmax = codes.shape
    nwin = q1s.shape[0]
    nflat = nwin * nreads
    use_k2 = winops.uses_second_key(width)

    cols = jnp.clip(q1s[:, None] + jnp.arange(width)[None, :], 0, lmax - 1)
    win = codes[:, cols].transpose(1, 0, 2).astype(jnp.uint32)  # (K, R, W)
    key = _horner(win, winops.key_multiplier(width))  # (K, R)
    key2 = _horner(win, winops.HASH_MULT2) if use_k2 else jnp.zeros_like(key)
    valid = lengths[None, :] >= q1s[:, None] + width  # (K, R)
    if min_dinuc > 0:
        # 25-bit dinucleotide presence mask + popcount == CountDinuc.
        bits = jnp.zeros(win.shape[:2], dtype=jnp.uint32)
        for i in range(width - 1):
            pr = win[:, :, i] * jnp.uint32(winops.NBASE) + win[:, :, i + 1]
            bits = bits | (jnp.uint32(1) << pr)
        valid = valid & (lax.population_count(bits).astype(jnp.int32) >= min_dinuc)

    return key.reshape(nflat), key2.reshape(nflat), valid.reshape(nflat)


def _window_queries(rpacked, lengths, q1s, *, width, min_dinuc):
    """Window keys + validity for every (window, read), flattened to
    (K*R,) window-major — computed from the nibble-packed read matrix.

    Per window: one dynamic column slice of the packed words, a funnel
    shift to align the window to nibble 0, then `width` static nibble
    extractions feeding the Horner fold and the dinucleotide mask.  All
    bulk strided ops — no per-element (K, R, W) byte gather."""
    nreads, nw = rpacked.shape
    nwin = q1s.shape[0]
    nflat = nwin * nreads
    use_k2 = winops.uses_second_key(width)
    mult = winops.key_multiplier(width)

    nal = -(-width // 8)  # aligned words covering the window
    nsl = nal + 1  # sliced words (one extra feeds the funnel shift)
    # One guard column keeps the last valid window's slice in bounds
    # (valid windows satisfy q1 + width <= lmax <= 8*nw, so their slice
    # never needs more than one word past the packed width; windows that
    # would read further are invalid for every row and may be garbage).
    padn = max(1, nsl - nw)
    rp = jnp.pad(rpacked, ((0, 0), (0, padn)))
    nwp = nw + padn

    keys, keys2, valids = [], [], []
    for k in range(nwin):
        q1 = q1s[k]
        w0 = jnp.clip(q1 >> 3, 0, nwp - nsl)
        sh = jnp.clip((q1 - (w0 << 3)) * 4, 0, 31).astype(jnp.uint32)
        words = lax.dynamic_slice(
            rp, (jnp.int32(0), w0.astype(jnp.int32)), (nreads, nsl)
        )
        al = []
        for j in range(nal):
            lo = words[:, j] >> sh
            hi = jnp.where(
                sh == 0, jnp.uint32(0), words[:, j + 1] << (jnp.uint32(32) - sh)
            )
            al.append(lo | hi)
        key = jnp.zeros(nreads, jnp.uint32)
        key2 = jnp.zeros(nreads, jnp.uint32)
        bits = jnp.zeros(nreads, jnp.uint32)
        prev = None
        for i in range(width):
            b = (al[i >> 3] >> jnp.uint32((i & 7) * 4)) & jnp.uint32(0xF)
            key = key * mult + b
            if use_k2:
                key2 = key2 * winops.HASH_MULT2 + b
            if min_dinuc > 0 and prev is not None:
                pr = prev * jnp.uint32(winops.NBASE) + b
                bits = bits | (jnp.uint32(1) << pr)
            prev = b
        v = lengths >= q1 + width
        if min_dinuc > 0:
            v = v & (lax.population_count(bits).astype(jnp.int32) >= min_dinuc)
        keys.append(key)
        keys2.append(key2)
        valids.append(v)

    key = jnp.stack(keys).reshape(nflat)
    key2 = (
        jnp.stack(keys2).reshape(nflat)
        if use_k2
        else jnp.zeros(nflat, jnp.uint32)
    )
    valid = jnp.stack(valids).reshape(nflat)
    return key, key2, valid


def _probe_windows_impl(rpacked, lengths, q1s, skeys, *, width, min_dinuc):
    """Sort-merge probe over the flat (K*R,) query space.

    Best when the index is not much larger than the query batch: one sort
    of (V + K*R) rows replaces every per-query lookup.  Returns compacted
    slot arrays of length K*R (active slots first) plus the qid-indexed
    query-key arrays and the exact pair totals:
      counts_m  candidate count of the query at each slot
      lo_m      start of the query's candidate run in the index
      qid_m     flat (window*R + read) query id
      keyf      (K*R,) key1 of every query, in qid order
      key2f     (K*R,) key2 of every query, in qid order
      total     exact candidate pair count (int32)
      totalf    the same as float32 (int32-overflow detection)
    """
    nreads = rpacked.shape[0]
    nwin = q1s.shape[0]
    nflat = nwin * nreads
    keyf, key2f, validf = _window_queries(
        rpacked, lengths, q1s, width=width, min_dinuc=min_dinuc
    )

    nidx = skeys.shape[0]
    m1 = jnp.concatenate([skeys, keyf])
    # The merge joins on key1 ALONE (key2 never rides the sort): for
    # width <= 13 key1 is exact, and for hashed widths a key1 collision
    # between distinct k-mers only adds candidate pairs that the byte-true
    # verify rejects (expected extras ~ Q*V/2**32 — a fraction of a
    # percent).  A 2-operand 1-key sort moves a third fewer bytes than the
    # 3-operand 2-key sort, and lets the index skip uploading skeys2
    # entirely (engine.index keeps a host-side placeholder).
    #
    # The payload word encodes row class:
    #   -1        index entry (stability keeps it before equal-key queries,
    #             because index rows precede queries in the concatenation)
    #   >= 0      valid query, value = flat query id
    #   -2        length-or-entropy-rejected query
    pay = jnp.concatenate(
        [
            jnp.full(nidx, -1, jnp.int32),
            jnp.where(validf, jnp.arange(nflat, dtype=jnp.int32), jnp.int32(-2)),
        ]
    )
    m1s, pay_s = lax.sort((m1, pay), num_keys=1, is_stable=True)

    seg = jnp.concatenate(
        [jnp.ones(1, bool), m1s[1:] != m1s[:-1]]
    )
    is_idx = (pay_s == -1).astype(jnp.int32)
    ie = jnp.cumsum(is_idx) - is_idx  # index entries strictly before j
    seg_ie = jax.lax.cummax(jnp.where(seg, ie, -1))  # ie at my segment start
    counts_m = jnp.where(pay_s >= 0, ie - seg_ie, 0).astype(jnp.int32)
    lo_m = jnp.maximum(seg_ie, 0)
    qid_m = jnp.where(pay_s >= 0, pay_s, -1)

    # Compact to the active (count > 0) slots so that consecutive pair
    # owners are consecutive array slots — this bounds every expansion
    # chunk's owner span by the chunk size.  The group keys are not
    # compacted at all: downstream stages carry qid and index keyf/key2f
    # directly (saves two 100M+-row sort operands AND two K*R gathers).
    # The inactive flag and the run start lo share one key word (lo <
    # 2**30 is asserted at trace time), so this sort runs 3-operand
    # single-key unstable.  Key ties exist only among index rows (qid -1),
    # whose order is irrelevant (count 0).  Ordering the active slots by
    # lo makes the expansion's postings index stream piecewise monotone.
    assert nflat < (1 << 30) - 1, "query space exceeds the packed-key range"
    assert skeys.shape[0] < (1 << 30), "index exceeds the packed-lo range"
    inactive = (counts_m == 0).astype(jnp.int32)
    packed_key = (inactive << 30) | jnp.clip(lo_m, 0, (1 << 30) - 1)
    packed_c, counts_c, qid_c = lax.sort(
        (packed_key, counts_m, qid_m), num_keys=1
    )
    counts_c, qid_c = counts_c[:nflat], qid_c[:nflat]
    lo_c = packed_c[:nflat] & ((1 << 30) - 1)
    total = jnp.sum(counts_c)
    totalf = jnp.sum(counts_c.astype(jnp.float32))
    return counts_c, lo_c, qid_c, keyf, key2f, total, totalf


def _probe_windows_direct_impl(
    rpacked, lengths, q1s, urec, sbucket,
    *, width, min_dinuc, upshift, bucket_bits, bucket_width,
):
    """Direct-bucket probe: the bucket table is sized (engine.index.
    build_search_aux) so no bucket holds more than `bucket_width` distinct
    keys, so a probe is TWO dependent coalesced fetches — bucket bounds
    (adjacent int32s, one burst) and the bucket's 16-byte (k1, k2, start,
    count) records — with no search loop, instead of ~12 dependent gather
    rounds per query of the bucketed binary search.  Same compacted return
    contract as _probe_windows_impl.
    """
    nreads = rpacked.shape[0]
    nwin = q1s.shape[0]
    nflat = nwin * nreads
    use_k2 = winops.uses_second_key(width)
    keyf0, key2f0, validf = _window_queries(
        rpacked, lengths, q1s, width=width, min_dinuc=min_dinuc
    )

    # Sort queries by key: neighboring lanes then fetch neighboring bucket
    # lines (locality), and the active-compaction below stays cheap.
    # keyf0/key2f0 (qid order) are returned for downstream group lookups.
    qid0 = jnp.arange(nflat, dtype=jnp.int32)
    keyf, key2f, vi, qid = lax.sort(
        (keyf0, key2f0, (~validf).astype(jnp.int32), qid0), num_keys=2
    )
    validf = vi == 0

    w = bucket_width

    def _chunk(args):
        # The (C, 4w) record fetch is the big temp; chunking bounds it so
        # large batches cannot exhaust device memory (queries are processed in ~1M-query
        # slices under lax.map, one compiled body).
        keyc, key2c, validc = args
        b = ((keyc << jnp.uint32(upshift)) >> jnp.uint32(32 - bucket_bits)).astype(
            jnp.int32
        )
        lo = sbucket[b]
        nb = sbucket[b + 1] - lo
        widx = lo[:, None] * 4 + jnp.arange(4 * w, dtype=jnp.int32)[None, :]
        rec = urec[widx]  # (C, 4w)
        rk1 = rec[:, 0::4]
        rk2 = rec[:, 1::4]
        rstart = rec[:, 2::4].astype(jnp.int32)
        rcount = rec[:, 3::4].astype(jnp.int32)
        in_bucket = jnp.arange(w, dtype=jnp.int32)[None, :] < nb[:, None]
        hit_j = in_bucket & (rk1 == keyc[:, None])
        if use_k2:
            hit_j = hit_j & (rk2 == key2c[:, None])
        hit = validc & jnp.any(hit_j, axis=1)
        c = jnp.where(hit, jnp.sum(jnp.where(hit_j, rcount, 0), axis=1), 0)
        lo_q = jnp.sum(jnp.where(hit_j, rstart, 0), axis=1)
        return c, lo_q

    chunk = min(nflat, 1 << 20)
    padq = (-nflat) % chunk
    def _padded(x, fill):
        return jnp.concatenate([x, jnp.full(padq, fill, x.dtype)]) if padq else x
    kq = _padded(keyf, 0).reshape(-1, chunk)
    k2q = _padded(key2f, 0).reshape(-1, chunk)
    vq = _padded(validf, False).reshape(-1, chunk)
    counts, loc = jax.lax.map(_chunk, (kq, k2q, vq))
    counts = counts.reshape(-1)[:nflat]
    loc = loc.reshape(-1)[:nflat]

    inactive = (counts == 0).astype(jnp.int32)
    # lo-ordered active slots, like the sort-merge probe: the
    # expansion's postings stream stays monotone on every probe type.
    _, lo_c, counts_c, qid_c = lax.sort(
        (inactive, loc, counts, qid), num_keys=2, is_stable=True
    )
    total = jnp.sum(counts_c)
    totalf = jnp.sum(counts_c.astype(jnp.float32))
    return counts_c, lo_c, qid_c, keyf0, key2f0, total, totalf


def _probe_windows_search_impl(
    rpacked, lengths, q1s, ukeys, ukeys2, ukk, ustart, ucount, sbucket,
    *, width, min_dinuc, upshift, probe_steps, bucket_bits,
):
    """Bucketed binary-search probe over the flat (K*R,) query space.

    Best when the index is much larger than the query batch (the sort-merge
    probe re-sorts the whole index per batch; this touches only
    O(K*R * probe_steps) gathered elements).  Queries are sorted by key
    first so consecutive lanes search neighboring index regions — gather
    locality is what limits throughput on a multi-hundred-MB index.  Same
    compacted return contract as _probe_windows_impl.
    """
    nreads = rpacked.shape[0]
    nwin = q1s.shape[0]
    nflat = nwin * nreads
    use_k2 = winops.uses_second_key(width)
    keyf0, key2f0, validf = _window_queries(
        rpacked, lengths, q1s, width=width, min_dinuc=min_dinuc
    )

    qid0 = jnp.arange(nflat, dtype=jnp.int32)
    keyf, key2f, vi, qid = lax.sort(
        (keyf0, key2f0, (~validf).astype(jnp.int32), qid0), num_keys=2
    )
    validf = vi == 0

    nuniq = ukeys.shape[0]
    lo_u = sops.searchsorted2_bucketed(
        ukeys, ukeys2, keyf, key2f, sbucket,
        upshift=upshift, steps=probe_steps, use_k2=use_k2,
        bucket_bits=bucket_bits, interleaved=ukk,
    )
    loc = jnp.minimum(lo_u, nuniq - 1)
    eq = ukeys[loc] == keyf
    if use_k2:
        eq = eq & (ukeys2[loc] == key2f)
    hit = validf & eq & (lo_u < nuniq)
    counts = jnp.where(hit, ucount[loc], 0).astype(jnp.int32)
    loc = jnp.where(hit, ustart[loc], 0)

    # Compact actives first (stable) — K*R-sized sort, index untouched.
    inactive = (counts == 0).astype(jnp.int32)
    # lo-ordered active slots, like the sort-merge probe: the
    # expansion's postings stream stays monotone on every probe type.
    _, lo_c, counts_c, qid_c = lax.sort(
        (inactive, loc, counts, qid), num_keys=2, is_stable=True
    )
    total = jnp.sum(counts_c)
    totalf = jnp.sum(counts_c.astype(jnp.float32))
    return counts_c, lo_c, qid_c, keyf0, key2f0, total, totalf


def _expand_verify_impl(
    counts_m, lo_m, qid_m, keyf, key2f, q1s, rpacked, lengths, spos,
    tpacked, gene_start, budget, trows=None, gblock=None,
    *, nreads, width, max_read_length, pair_chunk, surv_cap, smax, gsteps=0,
):
    """Returns (surv (surv_cap, NCOL) int32, nsurv, total, totalf) — nsurv
    may exceed surv_cap, signalling overflow; totalf is the exact pair
    count as float32, so the caller can detect int32 cumsum overflow
    (counts beyond ~2**30 pairs per batch require a smaller read batch).

    The inputs are compacted: every slot with count > 0 precedes all empty
    slots, so each chunk's owners occupy at most pair_chunk + 1 consecutive
    slots and all per-chunk work is O(pair_chunk), independent of the query
    count."""
    m = counts_m.shape[0]
    nflat = keyf.shape[0]
    offsets = jnp.cumsum(counts_m)  # inclusive
    total = offsets[-1]
    totalf = jnp.sum(counts_m.astype(jnp.float32))
    offsets_excl = offsets - counts_m

    span = pair_chunk + 1
    # Pad the slot arrays so a span-sized dynamic_slice starting at any
    # owner index stays in bounds.
    counts_p = jnp.concatenate([counts_m, jnp.zeros(span, jnp.int32)])
    oexcl_p = jnp.concatenate([offsets_excl, jnp.full(span, total, jnp.int32)])
    qid_p = jnp.concatenate([qid_m, jnp.full(span, -1, jnp.int32)])
    lo_p = jnp.concatenate([lo_m, jnp.zeros(span, lo_m.dtype)])

    nchunks = lax.div(total + (pair_chunk - 1), jnp.int32(pair_chunk))
    buf = jnp.zeros((surv_cap, NCOL), dtype=jnp.int32)

    def chunk_body(cstate):
        ci, nsurv, buf = cstate
        base = ci * pair_chunk
        pid = base + jnp.arange(pair_chunk, dtype=jnp.int32)
        # First owner of this chunk; its slot window is [ob, ob + span).
        seed = jnp.searchsorted(offsets, base, side="right").astype(jnp.int32)
        ob = jnp.minimum(seed, m)
        counts_l = lax.dynamic_slice(counts_p, (ob,), (span,))
        oexcl_l = lax.dynamic_slice(oexcl_p, (ob,), (span,))

        # Owner of each pair lane, as a local slot id: scatter each slot's
        # id at its run start within the chunk, forward-fill with cummax.
        pos_in_chunk = oexcl_l - base
        ok = (counts_l > 0) & (pos_in_chunk > 0) & (pos_in_chunk < pair_chunk)
        lanes = jnp.full(pair_chunk, -1, jnp.int32)
        lanes = lanes.at[jnp.where(ok, pos_in_chunk, pair_chunk + 1)].set(
            jnp.arange(span, dtype=jnp.int32), mode="drop"
        )
        lanes = lanes.at[0].set(0)
        owner = jnp.clip(lax.cummax(lanes), 0, span - 1)

        qid = lax.dynamic_slice(qid_p, (ob,), (span,))[owner]
        k_lane = jnp.maximum(qid, 0) // nreads
        r_lane = jnp.maximum(qid, 0) - k_lane * nreads
        q1_lane = q1s[k_lane]
        start = oexcl_l[owner]
        within = pid - start
        lo_owner = lax.dynamic_slice(lo_p, (ob,), (span,))[owner]
        site = spos[jnp.clip(lo_owner + within, 0, spos.shape[0] - 1)]
        in_range = (pid < total) & (qid >= 0)
        r = jnp.where(in_range, r_lane, -1)
        p = jnp.where(in_range, site, -1)

        keep, nx, g, s = pops.verify_pairs_packed(
            r, p, rpacked, lengths, tpacked, gene_start,
            budget, q1_lane, width, max_read_length, smax,
            trows=trows, gblock=gblock, gsteps=gsteps,
        )
        qc = jnp.clip(qid, 0, nflat - 1)
        grp = keyf[qc].astype(jnp.int32)
        grp2 = key2f[qc].astype(jnp.int32)

        pos = nsurv + jnp.cumsum(keep.astype(jnp.int32)) - 1
        idx = jnp.where(keep, pos, surv_cap + 1)  # OOB rows are dropped
        vals = jnp.stack([r, g, s, nx, grp, grp2, k_lane], axis=1)
        buf = buf.at[idx].set(vals, mode="drop")
        nsurv = nsurv + jnp.sum(keep.astype(jnp.int32))
        return ci + 1, nsurv, buf

    _, nsurv, buf = lax.while_loop(
        lambda st: st[0] < nchunks, chunk_body, (jnp.int32(0), jnp.int32(0), buf)
    )
    return buf, nsurv, total, totalf


def _expand_pairs_impl(counts_m, lo_m, qid_m, q1s, spos, *, nreads, pair_cap,
                       dorder=False, smax=None, max_read_length=0):
    """Vectorized pair expansion into a (pair_cap,) column buffer, sorted
    by (read, diagonal) with run-start bookkeeping for the diagonal-dedup
    verify.

    Expansion is one scatter + one cummax (no chunk loop): each active
    slot's id is scattered at its first pair lane and forward-filled, so
    every pair lane knows its owning query in O(pair_cap) dense work.
    Pairs are then sorted by (read row, diagonal d = site - q1); several
    windows of one read landing on the same diagonal become adjacent
    duplicates, which the verify stage resolves once per unique (r, d).

    The pair sort carries a single payload word: the flat query id, from
    which the verify stage recovers the window (qid // nreads), the read
    row (qid % nreads), and — via the qid-indexed keyf/key2f arrays — the
    k-mer cap-group identity of the surviving rows only.

    Returns (qid_s, u_idx, ur, ud, nuniq, total, totalf):
      qid_s    (pair_cap,) flat query id per pair, (r, d)-sorted; -1 = inactive
      u_idx    index of the pair's unique (r, d) in (ur, ud)
      ur/ud    compacted unique read rows / diagonals (prefix of nuniq)
      total    exact pair count (overflow if > pair_cap — caller regrows)
    """
    m = counts_m.shape[0]
    offsets = jnp.cumsum(counts_m)
    total = offsets[-1]
    totalf = jnp.sum(counts_m.astype(jnp.float32))
    oexcl = offsets - counts_m

    inf = jnp.int32(0x7FFFFFFF)
    pid = jnp.arange(pair_cap, dtype=jnp.int32)
    lanes = jnp.full(pair_cap, -1, jnp.int32)
    tgt = jnp.where(counts_m > 0, oexcl, pair_cap + 1)
    lanes = lanes.at[tgt].set(jnp.arange(m, dtype=jnp.int32), mode="drop")
    owner = jnp.clip(lax.cummax(lanes), 0, m - 1)
    qid = qid_m[owner]
    within = pid - oexcl[owner]
    sidx = jnp.clip(lo_m[owner] + within, 0, spos.shape[0] - 1)
    act = (pid < total) & (qid >= 0)
    k_lane = jnp.maximum(qid, 0) // nreads
    r_lane = jnp.maximum(qid, 0) - k_lane * nreads
    site = spos[sidx]
    d = site.astype(jnp.int32) - q1s[k_lane]

    # Sort by (read, diagonal) — or (diagonal, read) under dorder; either
    # total order yields the same unique-(r, d) set, the choice only
    # decides which verify fetch stream is monotone.  Inactive lanes key
    # to int32-max and sink to the end (no real read row or diagonal
    # reaches 2**31-1).
    #
    # qid = k*nreads + r, and r IS (part of) the sort key — so the window
    # index k (a couple of bits) rides the MINOR key's low bits and the
    # 32-bit qid payload operand disappears: the biggest sort after the
    # probe's drops from 3 operands to 2 (a third fewer bytes through the
    # sort).  k must sit BELOW the (r, d) order,
    # never above it, so run detection masks it off.  Gated on the packed
    # minor key fitting int32: d in [-q1, smax) with q1 <= max_read_length
    # for the non-dorder minor (d, k); r < nreads for the dorder minor
    # (r, k).  Callers that do not pass smax keep the payload sort.
    nwin = q1s.shape[0]
    kbits = max((nwin - 1).bit_length(), 1)
    kmax = (1 << kbits) - 1
    doff = max_read_length
    if smax is not None and dorder:
        packk = ((nreads << kbits) | kmax) < 0x7FFFFFFF
    elif smax is not None:
        packk = (((smax + doff) << kbits) | kmax) < 0x7FFFFFFF
    else:
        packk = False
    rkey = jnp.where(act, r_lane, inf)
    if packk and dorder:
        dkey = jnp.where(act, d, inf)
        minor = jnp.where(act, (r_lane << kbits) | k_lane, inf)
        d_s, minor_s = lax.sort((dkey, minor), num_keys=2)
        act_s = d_s != inf
        r_s = jnp.where(act_s, minor_s >> kbits, -1)
        d_s = jnp.where(act_s, d_s, 0)
        run_maj, run_min = d_s, minor_s >> kbits
    elif packk:
        minor = jnp.where(act, ((d + doff) << kbits) | k_lane, inf)
        rkey_s, minor_s = lax.sort((rkey, minor), num_keys=2)
        act_s = rkey_s != inf
        r_s = jnp.where(act_s, rkey_s, -1)
        d_s = jnp.where(act_s, (minor_s >> kbits) - doff, 0)
        run_maj, run_min = rkey_s, minor_s >> kbits
    elif dorder:
        qid_pay = jnp.where(act, qid, -1)
        dkey = jnp.where(act, d, inf)
        d_s, rkey_s, qid_s = lax.sort((dkey, rkey, qid_pay), num_keys=2)
        act_s = d_s != inf
        r_s = jnp.where(act_s, rkey_s, -1)
        d_s = jnp.where(act_s, d_s, 0)
        run_maj, run_min = d_s, rkey_s
    else:
        qid_pay = jnp.where(act, qid, -1)
        rkey_s, d_s, qid_s = lax.sort((rkey, d, qid_pay), num_keys=2)
        act_s = rkey_s != inf
        r_s = jnp.where(act_s, rkey_s, -1)
        run_maj, run_min = rkey_s, d_s
    if packk:
        k_s = jnp.where(act_s, minor_s & jnp.int32(kmax), 0)
        qid_s = jnp.where(act_s, k_s * nreads + jnp.maximum(r_s, 0), -1)

    run_start = (
        jnp.concatenate(
            [jnp.ones(1, bool),
             (run_maj[1:] != run_maj[:-1]) | (run_min[1:] != run_min[:-1])]
        )
        & act_s
    )
    u_idx = jnp.cumsum(run_start.astype(jnp.int32)) - 1
    nuniq = u_idx[-1] + 1
    # Compact the unique (r, d) run starts to a prefix with ONE unstable
    # 1-key sort instead of two full-lane scatters: run starts carry
    # their (unique, increasing) u_idx as the key, every other lane keys
    # to int32-max and sinks.  The sunk tail holds payloads of duplicate
    # lanes in arbitrary order, so it is masked inactive — the verify
    # chunks over ceil(nuniq/vchunk) lanes only.
    ukey = jnp.where(run_start, u_idx, inf)
    _, ur, ud = lax.sort((ukey, r_s, d_s), num_keys=1)
    lane = jnp.arange(pair_cap, dtype=jnp.int32)
    live = lane < nuniq
    ur = jnp.where(live, ur, -1)
    ud = jnp.where(live, ud, 0)
    return qid_s, u_idx, ur, ud, nuniq, total, totalf


def _verify_diagonals_impl(
    qid_s, u_idx, ur, ud, nuniq, keyf, key2f, q1s,
    rpacked, lengths, tpacked, gene_start, budget, trows=None, gblock=None,
    *, nreads, width, max_read_length, vchunk, surv_cap, smax, gsteps=0,
):
    """Chunked heavy verify over the unique (r, d) prefix, verdict map-back
    to the pair lanes, and survivor compaction.  Work in the gather-heavy
    verify is proportional to the number of UNIQUE diagonals (dynamic
    while_loop trip count), not to pair capacity.

    The pair lanes carry only qid (see _expand_pairs_impl); the
    compaction sort therefore runs on at most 4 operands — (dead|qid, nx,
    g, s) — and the cap-group key words are gathered from the qid-indexed
    keyf/key2f for the retained prefix only.

    Returns (surv (surv_cap, NCOL) int32, nsurv)."""
    cap = ur.shape[0]
    nwin = q1s.shape[0]
    nflat = keyf.shape[0]
    pad = jnp.zeros(vchunk, jnp.int32)
    ur_p = jnp.concatenate([ur, jnp.full(vchunk, -1, jnp.int32)])
    ud_p = jnp.concatenate([ud, pad])
    # (g, nx) share one buffer word when the static widths fit (nx is a
    # nibble-mismatch count <= rlen <= max_read_length; g < num_genes):
    # one loop-carried buffer, one map-back gather stream, and one
    # compaction sort operand fewer.
    xbits = max(int(max_read_length).bit_length(), 1)
    ngenes = int(gene_start.shape[0]) - 1
    pack_gnx = ((ngenes << xbits) | ((1 << xbits) - 1)) < 0x7FFFFFFF
    nval = 2 if pack_gnx else 3
    vb = tuple(jnp.zeros(cap + vchunk, jnp.int32) for _ in range(nval))
    okb = jnp.zeros(cap + vchunk, jnp.int32)

    nchunks = lax.div(nuniq + (vchunk - 1), jnp.int32(vchunk))

    def body(st):
        ci, vb, okb = st
        off = ci * vchunk
        rch = lax.dynamic_slice(ur_p, (off,), (vchunk,))
        dch = lax.dynamic_slice(ud_p, (off,), (vchunk,))
        nx, g, s, ok = pops.verify_diagonals_packed(
            rch, dch, rpacked, lengths, tpacked, gene_start, budget,
            q1s, width, max_read_length, smax,
            trows=trows, gblock=gblock, gsteps=gsteps,
        )
        if pack_gnx:
            vals = ((g << jnp.int32(xbits)) | nx, s)
        else:
            vals = (nx, g, s)
        vb = tuple(
            lax.dynamic_update_slice(b, v, (off,))
            for b, v in zip(vb, vals)
        )
        okb = lax.dynamic_update_slice(okb, ok, (off,))
        return ci + 1, vb, okb

    _, vb, okb = lax.while_loop(
        lambda st: st[0] < nchunks, body, (jnp.int32(0), vb, okb)
    )

    # Map verdict bits AND values back to pair lanes BEFORE the
    # compaction: u_idx is nondecreasing (increments <= 1 per lane), so
    # these gathers walk their tables in order, and the values then
    # travel through the compaction as sort payloads instead of being
    # fetched by three random gathers over the compacted lanes.
    uix = jnp.clip(u_idx, 0, cap - 1)
    kc = jnp.clip(jnp.maximum(qid_s, 0) // nreads, 0, nwin - 1)
    okw = okb[uix]
    ok = (okw >> kc) & 1
    keep = (qid_s >= 0) & (ok == 1)
    valw = tuple(b[uix] for b in vb)

    # Compaction: survivors first.  Dead lanes key to int32-max (no real
    # qid reaches 2**31-1), so one word orders the sort and the
    # pre-gathered values ride as payloads.
    take = min(surv_cap, cap)
    qd = jnp.where(keep, qid_s, jnp.int32(0x7FFFFFFF))
    sorted_ops = lax.sort((qd,) + valw, num_keys=1)
    qdt = sorted_ops[0][:take]
    valt = [o[:take] for o in sorted_ops[1:]]
    if pack_gnx:
        gnx_t, s2 = valt
        nx2 = gnx_t & jnp.int32((1 << xbits) - 1)
        g2 = lax.shift_right_logical(gnx_t, jnp.int32(xbits))
    else:
        nx2, g2, s2 = valt
    kt = jnp.clip(jnp.maximum(qdt, 0) // nreads, 0, nwin - 1)
    rt = jnp.maximum(qdt, 0) - kt * nreads
    # Dead tail lanes of the take-prefix hold int32-max; clamp them into
    # the query range (their rows lie past nsurv and are never read).
    qc = jnp.clip(qdt, 0, nflat - 1)
    gr1 = keyf[qc].astype(jnp.int32)
    gr2 = key2f[qc].astype(jnp.int32)
    surv = jnp.zeros((surv_cap, NCOL), jnp.int32)
    rows = jnp.stack([rt, g2, s2, nx2, gr1, gr2, kt], axis=1)
    surv = lax.dynamic_update_slice(surv, rows, (0, 0))
    nsurv = jnp.sum(keep.astype(jnp.int32))
    return surv, nsurv


def _pack64_fields(fields, bits):
    """LSB-first pack of nonnegative int32 fields into (lo, hi) uint32
    words; unsigned 64-bit comparison of the result is lexicographic
    comparison of the fields MSB-first (i.e. reversed(fields))."""
    lo = jnp.zeros_like(fields[0], dtype=jnp.uint32)
    hi = jnp.zeros_like(fields[0], dtype=jnp.uint32)
    pos = 0
    for v, b in zip(fields, bits):
        vu = v.astype(jnp.uint32)
        if b < 32:
            vu = vu & jnp.uint32((1 << b) - 1)
        if pos < 32:
            lo = lo | (vu << jnp.uint32(pos))
            if pos + b > 32:
                hi = hi | (vu >> jnp.uint32(32 - pos))
        else:
            hi = hi | (vu << jnp.uint32(pos - 32))
        pos += b
    return lo, hi


def _extract64(lo, hi, pos, b):
    """Field extraction from _pack64_fields words; pos and b static."""
    if pos >= 32:
        w = hi >> jnp.uint32(pos - 32)
    else:
        w = lo >> jnp.uint32(pos)
        if pos + b > 32:
            w = w | (hi << jnp.uint32(32 - pos))
    if b < 32:
        w = w & jnp.uint32((1 << b) - 1)
    return w.astype(jnp.int32)


def _u32(x):
    return lax.bitcast_convert_type(x, jnp.uint32)


def _pack_rows64(r, g, s, nx, pack_bits):
    """Pack (r, g, s, nx) into two int32 words (a 64-bit value split
    lo/hi), LSB-first field order (nx, s, g, r).  pack_bits is the static
    (rbits, gbits, sbits, xbits) tuple; the caller guarantees the fields
    fit (engine.pipeline derives the widths from the batch size, gene
    count, longest gene, and the mismatch-budget maximum).  Halves the
    retained-row fetch (8 bytes/match vs 16) — the dominant per-batch
    device->host transfer at realistic hit density."""
    rb, gb, sb, xb = pack_bits
    lo, hi = _pack64_fields((nx, s, g, r), (xb, sb, gb, rb))
    return jnp.stack(
        [lax.bitcast_convert_type(lo, jnp.int32),
         lax.bitcast_convert_type(hi, jnp.int32)],
        axis=1,
    )


def _rank_survivors_live_impl(buf, live, mm, mmtol, *, match_mode, full_cols=True):
    """Like _rank_survivors_impl but with an explicit live-row mask (the
    mesh path ranks an mp-gathered buffer whose live rows are per-block
    prefixes, not one global prefix)."""
    return _rank_core(buf, live, mm, mmtol, match_mode=match_mode,
                      full_cols=full_cols)


def _rank_survivors_impl(buf, nsurv, mm, mmtol, *, match_mode, surv_cap,
                         full_cols=True, pack_bits=None):
    """Device-side cap + dedup + best+MMTol over one batch's survivors.

    Replicates engine.pipeline._apply_max_matches and _dedup_and_rank
    exactly, in the same stage order as the reference (confirm's
    per-group cap BEFORE combine's dedup, cmd/muscato/main.go:387-505),
    so the host only fetches the retained rows.  Per-batch capping is
    safe: a group's global top-MaxMatches rows are a subset of the union
    of its per-batch top-MaxMatches rows, and the engine re-applies the
    cap over the (small) union across batches.

    Returns (rows (surv_cap, NCOL) int32 — retained prefix, in canonical
    (read, gene, start) order — and the retained count)."""
    live = jnp.arange(surv_cap, dtype=jnp.int32) < nsurv
    return _rank_core(buf, live, mm, mmtol, match_mode=match_mode,
                      full_cols=full_cols, pack_bits=pack_bits)


def _seg_min_broadcast(nxm, seg_id, n):
    """Per-segment min of nxm broadcast back to every lane (seg_id is
    dense and nondecreasing): a scatter-min into a per-segment table and
    an in-order gather back."""
    inf32 = jnp.int32(0x7FFFFFFF)
    table = jnp.full(n, inf32).at[seg_id].min(nxm, mode="drop")
    return table[seg_id]


def _rank_core_packed(buf, live, mm, mmtol, *, match_mode, pack_bits):
    """_rank_core with the (r, g, s, nx) columns packed into 64-bit
    lo/hi uint32 words through every sort: stage 1 runs on 5 operands
    instead of 8, stages 2 and 4 on 3 instead of 5 (fewer bytes through
    every sort).  Taken
    when the field widths fit 64 bits and the caller wants the packed
    return anyway (the single-batch engine path); the multi-batch/mesh
    re-cap path keeps the unpacked implementation, which doubles as the
    equivalence oracle (tests/test_kernels.py).  Group hash words are
    compared as uint32 — inter-group order differs from the signed
    compare of the unpacked path, but group membership, the in-group
    rank order, and the final canonical (r, g, s) order are identical,
    so the retained rows are bit-equal."""
    rb, gb, sb, xb = pack_bits
    n = buf.shape[0]
    r, g, s, nx = buf[:, 0], buf[:, 1], buf[:, 2], buf[:, 3]
    grp, grp2, win = buf[:, 4], buf[:, 5], buf[:, 6]
    dead = (~live).astype(jnp.int32)

    # 1. MaxMatches cap per (window, key1, key2) group.  In-group rank
    #    order matches the unpacked path exactly: (nx, g, s, r) for
    #    best, (g, s, r, nx) for first — packed LSB-first in reverse.
    dw = ((dead << 16) | win).astype(jnp.uint32)  # nwin << 2**16 always
    if match_mode == "first":
        lo1, hi1 = _pack64_fields((nx, r, s, g), (xb, rb, sb, gb))
    else:
        lo1, hi1 = _pack64_fields((r, s, g, nx), (rb, sb, gb, xb))
    dw, grp_s, grp2_s, hi1, lo1 = lax.sort(
        (dw, _u32(grp), _u32(grp2), hi1, lo1), num_keys=5
    )
    iota = jnp.arange(n, dtype=jnp.int32)
    newgrp = jnp.concatenate(
        [jnp.ones(1, bool),
         (dw[1:] != dw[:-1]) | (grp_s[1:] != grp_s[:-1])
         | (grp2_s[1:] != grp2_s[:-1])]
    )
    seg_start = lax.cummax(jnp.where(newgrp, iota, 0))
    rank = iota - seg_start
    cap = mm + jnp.int32(1 if match_mode == "first" else 0)
    keep = (dw < jnp.uint32(1 << 16)) & (rank < cap)

    # 2. exact dedup on (read, gene, start), canonical order.  nx is
    #    carried in the low bits of the packed key: it is a function of
    #    (r, g, s) — one verify per unique (read, diagonal) — so it
    #    never changes the order or the equality classes.
    if match_mode == "first":
        fields = [_extract64(lo1, hi1, p, b) for p, b in
                  ((0, xb), (xb, rb), (xb + rb, sb), (xb + rb + sb, gb))]
        nx2, r2, s2, g2 = fields
    else:
        fields = [_extract64(lo1, hi1, p, b) for p, b in
                  ((0, rb), (rb, sb), (rb + sb, gb), (rb + sb + gb, xb))]
        r2, s2, g2, nx2 = fields
    loc, hic = _pack64_fields((nx2, s2, g2, r2), (xb, sb, gb, rb))
    dead2 = (~keep).astype(jnp.uint32)
    dead2, hic, loc = lax.sort((dead2, hic, loc), num_keys=3)
    first_rgs = jnp.concatenate(
        [jnp.ones(1, bool), (hic[1:] != hic[:-1]) | (loc[1:] != loc[:-1])]
    )
    keep = (dead2 == 0) & first_rgs

    # 3. per-read best + MMTol (segment-min over the established order).
    inf32 = jnp.int32(0x7FFFFFFF)
    nx3 = _extract64(loc, hic, 0, xb)
    r3 = _extract64(loc, hic, xb + sb + gb, rb)
    nxm = jnp.where(keep, nx3, inf32)
    new_read = jnp.concatenate(
        [jnp.ones(1, bool),
         (r3[1:] != r3[:-1]) | (dead2[1:] != dead2[:-1])]
    )
    seg_id = jnp.cumsum(new_read.astype(jnp.int32)) - 1
    best = _seg_min_broadcast(nxm, seg_id, n)
    keep = keep & (nxm <= best + mmtol)

    # 4. stable single-key compaction; the packed words ARE the return.
    loc_i = lax.bitcast_convert_type(loc, jnp.int32)
    hic_i = lax.bitcast_convert_type(hic, jnp.int32)
    dead4 = (~keep).astype(jnp.uint32)
    _, hic_i, loc_i = lax.sort(
        (dead4, hic_i, loc_i), num_keys=1, is_stable=True
    )
    rows = jnp.stack([loc_i, hic_i], axis=1)
    count = jnp.sum(keep.astype(jnp.int32))
    return rows, count


def _rank_core(buf, live, mm, mmtol, *, match_mode, full_cols=True,
               pack_bits=None):
    if pack_bits is not None and not full_cols:
        return _rank_core_packed(
            buf, live, mm, mmtol, match_mode=match_mode, pack_bits=pack_bits,
        )
    n = buf.shape[0]
    r, g, s, nx = buf[:, 0], buf[:, 1], buf[:, 2], buf[:, 3]
    grp, grp2, win = buf[:, 4], buf[:, 5], buf[:, 6]
    dead = (~live).astype(jnp.int32)

    # 1. MaxMatches cap per (window, key1, key2) group
    #    ('first' emits MaxMatches+1 like the reference's append-then-check).
    if match_mode == "first":
        ops = (dead, win, grp, grp2, g, s, r, nx)
    else:
        ops = (dead, win, grp, grp2, nx, g, s, r)
    sorted_ops = lax.sort(ops, num_keys=len(ops))
    dead_s = sorted_ops[0]
    if match_mode == "first":
        _, win, grp, grp2, g, s, r, nx = sorted_ops
    else:
        _, win, grp, grp2, nx, g, s, r = sorted_ops
    iota = jnp.arange(n, dtype=jnp.int32)
    newgrp = jnp.concatenate(
        [jnp.ones(1, bool),
         (win[1:] != win[:-1]) | (grp[1:] != grp[:-1]) | (grp2[1:] != grp2[:-1])]
    )
    seg_start = lax.cummax(jnp.where(newgrp, iota, 0))
    rank = iota - seg_start
    cap = mm + jnp.int32(1 if match_mode == "first" else 0)
    keep = (dead_s == 0) & (rank < cap)

    # Stages 2-4 never consult the group/window columns; they ride the
    # sorts only so full_cols callers (multi-batch re-cap) get them back.
    # Single-batch callers drop them here: three fewer operands through
    # three surv_cap-row sorts.
    if full_cols:
        extras = (grp, grp2, win)
    else:
        extras = ()

    # 2. exact dedup on (read, gene, start).  This sort also establishes
    #    the FINAL canonical order: live rows first, then (r, g, s) —
    #    stages 3 and 4 never reorder again.
    dead2 = (~keep).astype(jnp.int32)
    dead2, r, g, s, nx, *extras = lax.sort(
        (dead2, r, g, s, nx, *extras), num_keys=4
    )
    first_rgs = jnp.concatenate(
        [jnp.ones(1, bool),
         (r[1:] != r[:-1]) | (g[1:] != g[:-1]) | (s[1:] != s[:-1])]
    )
    keep = (dead2 == 0) & first_rgs

    # 3. per-read best + MMTol — as a SEGMENT-MIN over the existing
    #    (r, g, s) order instead of a third full multi-operand sort: the
    #    kept rows of one read are already contiguous, so scatter-min
    #    their nmiss into a per-segment table and gather it back (a sort
    #    would carry 5-8 operands for what is a 1-word reduction).  Dead rows must not contribute: a row capped
    #    out in stage 1 may carry a smaller nmiss than any surviving row.
    inf32 = jnp.int32(0x7FFFFFFF)
    nxm = jnp.where(keep, nx, inf32)
    new_read = jnp.concatenate(
        [jnp.ones(1, bool), (r[1:] != r[:-1]) | (dead2[1:] != dead2[:-1])]
    )
    seg_id = jnp.cumsum(new_read.astype(jnp.int32)) - 1
    best = _seg_min_broadcast(nxm, seg_id, n)
    # best+mmtol may wrap for all-dead segments (best = int32-max); keep
    # is already false there.
    keep = keep & (nxm <= best + mmtol)

    # 4. compact the kept rows to the front.  Order within kept rows is
    #    already canonical (r, g, s), so one STABLE single-key sort
    #    replaces the former 4-key compaction.
    dead4 = (~keep).astype(jnp.int32)
    dead4, r, g, s, nx, *extras = lax.sort(
        (dead4, r, g, s, nx, *extras), num_keys=1, is_stable=True
    )
    if full_cols:
        rows = jnp.stack([r, g, s, nx, *extras], axis=1)
    elif pack_bits is not None:
        rows = _pack_rows64(r, g, s, nx, pack_bits)
    else:
        # Single-batch callers never re-cap across batches, so the group
        # columns stay on device (the retained-row fetch is the dominant
        # per-batch transfer at realistic hit density).
        rows = jnp.stack([r, g, s, nx], axis=1)
    count = jnp.sum(keep.astype(jnp.int32))
    return rows, count


def rank_survivors(buf, nsurv, mm, mmtol, *, match_mode, surv_cap,
                   full_cols=True, pack_bits=None):
    fn = _jit(
        _rank_survivors_impl,
        ("match_mode", "surv_cap", "full_cols", "pack_bits"),
    )
    return fn(
        buf, nsurv, jnp.int32(mm), jnp.int32(mmtol),
        match_mode=match_mode, surv_cap=surv_cap, full_cols=full_cols,
        pack_bits=pack_bits,
    )


def probe_windows(rpacked, lengths, q1s, skeys, *, width, min_dinuc,
                  index_aux=None):
    """Probe stage only: one async device dispatch.

    index_aux, when given, is a SearchAux (engine.index) and selects the
    bucketed-search probe — the right choice when the index is much larger
    than the query batch and the batch is small.  Returns the 7-tuple
    (counts_m, lo_m, qid_m, keyf, key2f, total, totalf); `total` lets the
    caller size the pair buffer exactly before dispatching the expand
    stage (one scalar fetch — no overflow/regrow round trips).
    """
    if index_aux is not None and index_aux.mode == "direct":
        aux = index_aux
        from ..engine.index import DIRECT_BUCKET_WIDTH

        probe = _jit(
            _probe_windows_direct_impl,
            ("width", "min_dinuc", "upshift", "bucket_bits", "bucket_width"),
        )
        return probe(
            rpacked, lengths, q1s, aux.urec, aux.sbucket,
            width=width, min_dinuc=min_dinuc, upshift=aux.upshift,
            bucket_bits=aux.bucket_bits, bucket_width=DIRECT_BUCKET_WIDTH,
        )
    if index_aux is not None:
        aux = index_aux
        probe = _jit(
            _probe_windows_search_impl,
            ("width", "min_dinuc", "upshift", "probe_steps", "bucket_bits"),
        )
        return probe(
            rpacked, lengths, q1s, aux.ukeys, aux.ukeys2, aux.ukk, aux.ustart,
            aux.ucount, aux.sbucket,
            width=width, min_dinuc=min_dinuc, upshift=aux.upshift,
            probe_steps=aux.probe_steps, bucket_bits=aux.bucket_bits,
        )
    probe = _jit(_probe_windows_impl, ("width", "min_dinuc"))
    return probe(rpacked, lengths, q1s, skeys, width=width, min_dinuc=min_dinuc)


def expand_verify_streamed(
    probe_out, q1s, rpacked, lengths, spos, tpacked, gene_start, budget,
    *, width, max_read_length, pair_chunk, surv_cap, smax,
    trows=None, gblock=None, gsteps=0,
):
    """Streaming expand+verify from a probe_windows result: chunked pair
    expansion inside a device while_loop, O(pair_chunk) memory regardless
    of the batch's pair count.  Returns (surv, nsurv, total, totalf)."""
    counts_m, lo_m, qid_m, keyf, key2f, _total, _totalf = probe_out
    expand = _jit(
        _expand_verify_impl,
        ("nreads", "width", "max_read_length", "pair_chunk", "surv_cap",
         "smax", "gsteps"),
    )
    return expand(
        counts_m, lo_m, qid_m, keyf, key2f, q1s, rpacked, lengths, spos,
        tpacked, gene_start, budget, trows, gblock,
        nreads=rpacked.shape[0], width=width,
        max_read_length=max_read_length,
        pair_chunk=pair_chunk, surv_cap=surv_cap, smax=smax, gsteps=gsteps,
    )


def expand_verify_dedup(
    probe_out, q1s, rpacked, lengths, spos, tpacked, gene_start, budget,
    *, width, max_read_length, pair_cap, vchunk, surv_cap, smax,
    trows=None, gblock=None, gsteps=0,
):
    """Diagonal-dedup expand+verify from a probe_windows result: two async
    dispatches (expand/sort -> verify/compact).  Pairs are materialized
    into a (pair_cap,) buffer and verified once per unique (read,
    diagonal); the heavy SWAR gathers drop ~K-fold when K windows hit one
    site, and the sorted pair order gives one verify fetch stream
    sequential locality.  Returns (surv, nsurv, total, totalf); total >
    pair_cap signals pair-buffer overflow (callers that size pair_cap
    from probe_out's total never see it)."""
    counts_m, lo_m, qid_m, keyf, key2f, _total, _totalf = probe_out
    nreads = rpacked.shape[0]
    expand = _jit(
        _expand_pairs_impl,
        ("nreads", "pair_cap", "dorder", "smax", "max_read_length"),
    )
    qid_s, u_idx, ur, ud, nuniq, total, totalf = expand(
        counts_m, lo_m, qid_m, q1s, spos, nreads=nreads, pair_cap=pair_cap,
        dorder=_DORDER[0], smax=smax, max_read_length=max_read_length,
    )
    verify = _jit(
        _verify_diagonals_impl,
        ("nreads", "width", "max_read_length", "vchunk", "surv_cap",
         "smax", "gsteps"),
    )
    surv, nsurv = verify(
        qid_s, u_idx, ur, ud, nuniq, keyf, key2f, q1s,
        rpacked, lengths, tpacked, gene_start, budget, trows, gblock,
        nreads=nreads, width=width, max_read_length=max_read_length,
        vchunk=vchunk, surv_cap=surv_cap, smax=smax, gsteps=gsteps,
    )
    return surv, nsurv, total, totalf


def match_windows(
    rpacked, lengths, q1s, skeys, spos, tpacked, gene_start, budget,
    *, width, min_dinuc, max_read_length, pair_chunk, surv_cap, smax,
    index_aux=None,
):
    """Probe + streaming expand/verify in one call (two async dispatches).
    See probe_windows / expand_verify_streamed for the split form the
    engine uses."""
    pr = probe_windows(
        rpacked, lengths, q1s, skeys,
        width=width, min_dinuc=min_dinuc, index_aux=index_aux,
    )
    return expand_verify_streamed(
        pr, q1s, rpacked, lengths, spos, tpacked, gene_start, budget,
        width=width, max_read_length=max_read_length,
        pair_chunk=pair_chunk, surv_cap=surv_cap, smax=smax,
    )
