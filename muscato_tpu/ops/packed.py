"""Nibble-packed sequences and the SWAR verification kernel.

The scalar verify (verify.py) gathers one byte per base — (pairs x readlen)
elements.  Here sequences are packed 8 bases per uint32 (one 4-bit nibble
per base, little-endian nibble order), so verification of a pair becomes

  - a gather of ceil(L/8)+1 words from the packed target stream,
  - a funnel shift to align the target diagonal to the read words,
  - xor + nibble-nonzero SWAR + population_count to count mismatches.

This cuts HBM gather traffic 8x and vector work ~16x versus the byte path.
Results are bit-identical to verify.verify_pairs_dynq (fuzz-tested); the
byte path remains as the readable reference implementation.

Mismatch semantics (X==X equal, window region must match exactly, budget
and fit rules) are unchanged — see verify.py for the reference file:line
contract citations.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

BASES_PER_WORD = 8
# numpy scalar on purpose: a module-level jnp constant would initialize
# the XLA backend at import time, which breaks jax.distributed.initialize
# (it must run before any backend touch on multi-host pods).
_NIB1 = np.uint32(0x11111111)


def packed_width(l: int) -> int:
    return -(-l // BASES_PER_WORD)


@partial(jax.jit, static_argnames=())
def pack_rows(codes: jnp.ndarray) -> jnp.ndarray:
    """(R, L) uint8 codes -> (R, ceil(L/8)) uint32, nibble-packed.

    Pad columns (beyond each row's length) must already be zero; they are
    masked during verification anyway.
    """
    nrows, l = codes.shape
    nw = packed_width(l)
    pad = nw * BASES_PER_WORD - l
    if pad:
        codes = jnp.pad(codes, ((0, 0), (0, pad)))
    w = codes.reshape(nrows, nw, BASES_PER_WORD).astype(jnp.uint32)
    shifts = jnp.arange(BASES_PER_WORD, dtype=jnp.uint32) * 4
    return jnp.sum(w << shifts[None, None, :], axis=2, dtype=jnp.uint32)


def pack_rows_all_np(codes, l_eff: int, chunk: int = 1 << 22) -> np.ndarray:
    """Pack an entire (N, L) read collection to (N, ceil(l_eff/8)) uint32
    in row slices: pack_rows_np materializes an (n, nw, 8) uint32 temp
    (4x the codes' bytes), so packing 100M rows at once would need ~40GB
    — sliced, the temp peaks at ~chunk * l_eff * 4 bytes while the
    output is written in place.  codes may be a memmap (chunked prep);
    the pass reads it sequentially once."""
    n = codes.shape[0]
    nw = packed_width(l_eff)
    out = np.empty((n, nw), np.uint32)
    for b0 in range(0, n, chunk):
        b1 = min(b0 + chunk, n)
        out[b0:b1] = pack_rows_np(np.ascontiguousarray(codes[b0:b1, :l_eff]))
    return out


def pack_rows_np(codes: np.ndarray) -> np.ndarray:
    """NumPy twin of pack_rows — lets the host ship 4-bit nibbles to the
    device (8x less transfer than the byte codes; the device unpacks)."""
    nrows, l = codes.shape
    nw = packed_width(l)
    pad = nw * BASES_PER_WORD - l
    if pad:
        codes = np.pad(codes, ((0, 0), (0, pad)))
    w = codes.reshape(nrows, nw, BASES_PER_WORD).astype(np.uint32)
    shifts = (np.arange(BASES_PER_WORD, dtype=np.uint32) * 4).astype(np.uint32)
    return np.sum(w << shifts[None, None, :], axis=2, dtype=np.uint32)


# Tail padding on the packed target stream: enough words that a full
# max-length read slice starting at the last base stays in bounds
# (supports MaxReadLength up to 4096).
STREAM_PAD_WORDS = packed_width(4096) + 2


def pack_stream(tcat: np.ndarray) -> jnp.ndarray:
    """(S,) uint8 codes -> (ceil(S/8)+PAD,) uint32 with zero tail padding."""
    s = len(tcat)
    nw = packed_width(max(s, 1))
    arr = np.zeros((nw + STREAM_PAD_WORDS) * BASES_PER_WORD, dtype=np.uint32)
    arr[:s] = tcat
    arr = arr.reshape(-1, BASES_PER_WORD)
    shifts = (np.arange(BASES_PER_WORD, dtype=np.uint32) * 4).astype(np.uint32)
    return jnp.asarray(np.sum(arr << shifts[None, :], axis=1, dtype=np.uint32))


# ---- Row-gather target view -------------------------------------------
#
# One ROW gather from a 2-D table fetches a diagonal's words in one
# contiguous read per lane, where an element gather issues nwords + 1
# separate index lookups per lane.  The verify kernels therefore fetch the
# target diagonal from `trows`, an overlapping strided view of the packed
# stream: trows[i] = tpacked[8*i : 8*i + rowlen].  A diagonal's
# word offset within its row is in [0, 8), resolved by a 3-level select
# tree (static slices, VPU work).  rowlen = nwords + 9: nwords + 1 fetched
# words + up to 7 offset words + 1 guard.

TROWS_GUARD = 9
GENE_BLOCK_BITS = 8  # gene block table: one entry per 256 stream positions


def trows_nrows(smax: int) -> int:
    return max(1, (max(smax, 1) - 1) // 64 + 1)


@partial(jax.jit, static_argnames=("nwords", "smax"))
def build_trows(tpacked: jnp.ndarray, nwords: int, smax: int) -> jnp.ndarray:
    """Overlapping (nrows, nwords + 9) uint32 view of the packed stream,
    one row per 64 stream positions.  Built once per (index, read width);
    2.75x the packed stream's bytes."""
    rowlen = nwords + TROWS_GUARD
    nrows = trows_nrows(smax)
    need = 8 * (nrows - 1) + rowlen
    tp = tpacked
    if tp.shape[0] < need:
        tp = jnp.pad(tp, (0, need - tp.shape[0]))
    cols = [
        lax.slice(tp, (j,), (j + 8 * (nrows - 1) + 1,), (8,))
        for j in range(rowlen)
    ]
    return jnp.stack(cols, axis=1)


def _trows_select(t: jnp.ndarray, woff: jnp.ndarray, nwords: int) -> jnp.ndarray:
    """3-level column select: rows fetched from trows -> the nwords+1
    stream words starting at each lane's in-row word offset (in [0, 8))."""
    t = jnp.where((woff & 4).astype(bool)[:, None], t[:, 4:], t[:, : t.shape[1] - 4])
    t = jnp.where((woff & 2).astype(bool)[:, None], t[:, 2:], t[:, : t.shape[1] - 2])
    t = jnp.where((woff & 1).astype(bool)[:, None], t[:, 1:], t[:, : t.shape[1] - 1])
    return t[:, : nwords + 1]


def _trows_fetch(trows: jnp.ndarray, dc: jnp.ndarray, nwords: int) -> jnp.ndarray:
    """Words tpacked[dc>>3 : (dc>>3) + nwords + 1] per lane, via one row
    gather + 3-level column select."""
    base = dc >> 3
    row = base >> 3
    woff = base & 7
    t = trows[jnp.clip(row, 0, trows.shape[0] - 1)]
    return _trows_select(t, woff, nwords)


def build_gene_block(gene_start_np: np.ndarray, smax: int):
    """Host-built block table for gene_of_pos_block: gblock[b] = owning
    gene of stream position b*256, plus the refine step count (log2 of the
    widest block's gene span).  G+1 binary-search steps collapse to
    1 block lookup + `steps` refines (steps is 1-2 for real gene sizes)."""
    gs = np.asarray(gene_start_np, dtype=np.int64)
    nb = (max(smax, 1) >> GENE_BLOCK_BITS) + 2
    marks = np.arange(nb, dtype=np.int64) << GENE_BLOCK_BITS
    gb = (np.searchsorted(gs[: len(gs)], marks, side="right") - 1).astype(np.int32)
    gb = np.clip(gb, 0, max(len(gs) - 2, 0))
    span = int((gb[1:] - gb[:-1]).max(initial=0))
    steps = max(span, 1).bit_length()
    return gb, steps


def gene_of_pos_block(
    gene_start: jnp.ndarray, gblock: jnp.ndarray, p: jnp.ndarray, steps: int
) -> jnp.ndarray:
    """gene_of_pos via the block table: bounds from two adjacent gblock
    entries, then `steps` branchless refine iterations."""
    g = gene_start.shape[0] - 1
    b = (p >> GENE_BLOCK_BITS).astype(jnp.int32)
    lo = gblock[jnp.clip(b, 0, gblock.shape[0] - 1)]
    hi = gblock[jnp.clip(b + 1, 0, gblock.shape[0] - 1)]
    for _ in range(steps):
        mid = (lo + hi + 1) >> 1
        up = gene_start[jnp.clip(mid, 0, g)] <= p
        lo = jnp.where(up, mid, lo)
        hi = jnp.where(up, hi, mid - 1)
    return lo


def gene_of_pos(gene_start: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Owning gene of each stream position: the largest g with
    gene_start[g] <= p, as an unrolled branchless binary search over the
    (G+1,) offsets table.

    Replaces the 4-bytes-per-base gene id array the round-1 index carried —
    at 100M+ bases that array was the HBM budget; this table is G+1 entries
    and its top search levels stay cache-resident."""
    g = gene_start.shape[0] - 1  # number of genes
    lo = jnp.zeros(p.shape, jnp.int32)
    hi = jnp.full(p.shape, max(g - 1, 0), jnp.int32)
    for _ in range(max(1, max(g - 1, 1).bit_length())):
        mid = (lo + hi + 1) >> 1
        go_up = gene_start[mid] <= p
        lo = jnp.where(go_up, mid, lo)
        hi = jnp.where(go_up, hi, mid - 1)
    return lo


def _nibble_mask(k: jnp.ndarray) -> jnp.ndarray:
    """Mask with the low `k` nibbles set (k in [0, 8]), elementwise."""
    k = jnp.clip(k, 0, BASES_PER_WORD)
    full = k >= BASES_PER_WORD
    m = (jnp.uint32(1) << (k.astype(jnp.uint32) * 4)) - jnp.uint32(1)
    return jnp.where(full, jnp.uint32(0xFFFFFFFF), m)


def verify_diagonals_packed(
    r: jnp.ndarray,  # (C,) int32 read rows (-1 = inactive lane)
    d: jnp.ndarray,  # (C,) int32 global read-start positions (diagonals)
    rpacked: jnp.ndarray,  # (R, NW) uint32 nibble-packed reads
    lengths: jnp.ndarray,  # (R,) int32
    tpacked: jnp.ndarray,  # (SW+pad,) uint32 nibble-packed target stream
    gene_start: jnp.ndarray,  # (G+1,) int32
    budget: jnp.ndarray,  # (max_read_length+1,) int32
    q1s: jnp.ndarray,  # (K,) int32 window offsets (traced)
    width: int,
    max_read_length: int,
    smax: int,
    trows: jnp.ndarray | None = None,
    gblock: jnp.ndarray | None = None,
    gsteps: int = 0,
):
    """Verify one (read, diagonal) once for ALL windows at once.

    Several windows of a read routinely land on the same diagonal (the
    planted site), and the expensive part of verification — the packed
    target gather, the xor, and the full-length mismatch popcount —
    depends only on (read, diagonal).  The per-window residue is cheap
    VPU work: the exact-window-region mask, the left/fit checks, and the
    reference's pos-0 cap quirk (see verify.py for the file:line
    contract).  Returns (nx, g, s, okbits) where bit k of okbits says
    "a pair from window k on this diagonal passes verification".

    Equivalences with verify_pairs_packed (fuzz-tested):
      left_ok   <=> d >= 0 and d + q1_k < gene_end(gene(d))
      fit_ok    <=> rlen + s <= glen   (the max_read_length arm of the
                 reference cap is always true since rlen <= MaxReadLength),
                 except the pos-0 quirk: q1_k == 0 and s == 0 caps at
                 rlen <= min(glen, 100 - width)
      win_ok    <=> zero mismatching nibbles under window k's mask
      budget/nx are diagonal-level by definition.

    The caller sorts lanes by (read, diagonal) or (diagonal, read), so one
    of the two row-gather streams walks its table in order."""
    nwords = rpacked.shape[1]
    nwin = q1s.shape[0]
    active = (r >= 0) & (d >= 0)
    rc = jnp.clip(r, 0, rpacked.shape[0] - 1)
    dc = jnp.clip(d, 0, smax - 1)
    if gblock is not None:
        g = gene_of_pos_block(gene_start, gblock, dc, gsteps)
    else:
        g = gene_of_pos(gene_start, dc)
    gstart = gene_start[g]
    gend = gene_start[g + 1]
    glen = gend - gstart
    s_local = dc - gstart
    rlen = lengths[rc]

    # ---- SWAR mismatch count over the aligned diagonal (once) ----
    rshift = (dc & 7).astype(jnp.uint32) * 4
    if trows is not None:
        tw = _trows_fetch(trows, dc, nwords)  # (C, NW+1), one gather/lane
    else:
        base = dc >> 3
        widx = jnp.arange(nwords + 1, dtype=jnp.int32)
        gidx = jnp.clip(base[:, None] + widx[None, :], 0, tpacked.shape[0] - 1)
        tw = tpacked[gidx]  # (C, NW+1)
    lowpart = tw[:, :-1] >> rshift[:, None]
    hipart = jnp.where(
        (rshift == 0)[:, None],
        jnp.uint32(0),
        tw[:, 1:] << (jnp.uint32(32) - rshift[:, None]),
    )
    taligned = lowpart | hipart

    x = taligned ^ rpacked[rc]
    wordbase = jnp.arange(nwords, dtype=jnp.int32) * BASES_PER_WORD
    mask_len = _nibble_mask(rlen[:, None] - wordbase[None, :])
    x = x & mask_len
    nz = (x | (x >> 1) | (x >> 2) | (x >> 3)) & _NIB1
    nx = jnp.sum(lax.population_count(nz), axis=1).astype(jnp.int32)

    budget_ok = nx <= budget[jnp.clip(rlen, 0, budget.shape[0] - 1)]
    fit_norm = (rlen + s_local) <= glen
    fit_pos0 = rlen <= jnp.minimum(glen, jnp.int32(100 - width))

    okbits = jnp.zeros(r.shape, jnp.int32)
    for k in range(nwin):
        q1k = q1s[k]
        q2k = q1k + width
        left_ok = (dc + q1k) < gend
        is_pos0 = (q1k == 0) & (s_local == 0)
        fit_ok = jnp.where(is_pos0, fit_pos0, fit_norm)
        wmask = _nibble_mask(q2k - wordbase) & ~_nibble_mask(q1k - wordbase)
        win_mm = jnp.sum(lax.population_count(nz & wmask[None, :] & _NIB1), axis=1)
        bit = left_ok & fit_ok & (win_mm == 0)
        okbits = okbits | (bit.astype(jnp.int32) << k)

    okbits = jnp.where(active & budget_ok, okbits, 0)
    return nx, g.astype(jnp.int32), s_local.astype(jnp.int32), okbits


def verify_pairs_packed(
    r: jnp.ndarray,  # (P,) int32 read rows (-1 = inactive lane)
    p: jnp.ndarray,  # (P,) int32 global window positions (-1 = inactive)
    rpacked: jnp.ndarray,  # (R, NW) uint32 nibble-packed reads
    lengths: jnp.ndarray,  # (R,) int32
    tpacked: jnp.ndarray,  # (SW+2,) uint32 nibble-packed target stream
    gene_start: jnp.ndarray,  # (G+1,) int32
    budget: jnp.ndarray,  # (max_read_length+1,) int32
    q1,  # int32 scalar or (P,) vector — window offset per pair lane
    width: int,
    max_read_length: int,
    smax: int,
    trows: jnp.ndarray | None = None,
    gblock: jnp.ndarray | None = None,
    gsteps: int = 0,
):
    """SWAR equivalent of verify.verify_pairs_dynq; returns (keep, nx, g, s).

    q1 may vary per lane, so pairs from different windows can share one
    verification dispatch.  smax is the target stream length in bases.
    """
    nwords = rpacked.shape[1]
    active = (r >= 0) & (p >= 0)
    rc = jnp.clip(r, 0, rpacked.shape[0] - 1)
    pc = jnp.clip(p, 0, smax - 1)
    q1 = jnp.broadcast_to(jnp.asarray(q1, jnp.int32), r.shape)

    if gblock is not None:
        g = gene_of_pos_block(gene_start, gblock, pc, gsteps)
    else:
        g = gene_of_pos(gene_start, pc)
    gstart = gene_start[g]
    glen = gene_start[g + 1] - gstart
    p_local = pc - gstart
    rlen = lengths[rc]

    s_local = p_local - q1
    left_ok = s_local >= 0

    # Right-tail fit, incl. the reference's pos-0 cap quirk (see verify.py).
    q2 = q1 + width
    cap_norm = p_local + width + (max_read_length - q2)
    cap_pos0 = jnp.int32(100 - q2)
    is_pos0 = (p_local == 0) & (q1 == 0)
    cap_abs = jnp.where(is_pos0, cap_pos0, cap_norm)
    mrgt_len = jnp.minimum(glen, cap_abs) - (p_local + width)
    srgt_len = rlen - q2
    fit_ok = srgt_len <= mrgt_len

    # ---- SWAR mismatch count over the aligned diagonal ----
    d = pc - q1  # global read-start position
    dc = jnp.maximum(d, 0)
    rshift = (dc & 7).astype(jnp.uint32) * 4

    if trows is not None:
        tw = _trows_fetch(trows, dc, nwords)  # (P, NW+1), one gather/lane
    else:
        # (NW+1) words per pair as a plain element gather over an index
        # matrix.
        base = dc >> 3  # dc // 8
        widx = jnp.arange(nwords + 1, dtype=jnp.int32)
        gidx = jnp.clip(base[:, None] + widx[None, :], 0, tpacked.shape[0] - 1)
        tw = tpacked[gidx]  # (P, NW+1)
    lowpart = tw[:, :-1] >> rshift[:, None]
    hipart = jnp.where(
        (rshift == 0)[:, None],
        jnp.uint32(0),
        tw[:, 1:] << (jnp.uint32(32) - rshift[:, None]),
    )
    taligned = lowpart | hipart  # (P, NW) target words on the read frame

    rw = rpacked[rc]  # (P, NW)
    x = taligned ^ rw

    # Per-word masks from read length and window extent.
    wordbase = jnp.arange(nwords, dtype=jnp.int32) * BASES_PER_WORD  # (NW,)
    mask_len = _nibble_mask(rlen[:, None] - wordbase[None, :])  # (P, NW)
    x = x & mask_len
    nz = (x | (x >> 1) | (x >> 2) | (x >> 3)) & _NIB1  # 1 bit per differing base
    nx = jnp.sum(lax.population_count(nz), axis=1).astype(jnp.int32)

    win_mask = _nibble_mask(q2[:, None] - wordbase[None, :]) & ~_nibble_mask(
        q1[:, None] - wordbase[None, :]
    )
    win_mm = jnp.sum(lax.population_count(nz & win_mask & _NIB1), axis=1)

    keep = (
        active
        & left_ok
        & fit_ok
        & (win_mm == 0)
        & (nx <= budget[jnp.clip(rlen, 0, budget.shape[0] - 1)])
    )
    return keep, nx, g.astype(jnp.int32), s_local.astype(jnp.int32)
