"""Target index: the device-resident replacement for the Bloom screen.

The reference sketches the *reads* in Bloom filters and streams every target
window through them (cmd/muscato_screen/main.go:116-207, 408-480), then
re-derives exact candidates with an external sort-merge join
(cmd/muscato_confirm/main.go:375-416).  Here the roles are flipped the way
BASELINE.json prescribes: the *targets* are compiled once into a sorted
window-key index in device memory, and read batches probe it.  The probe is
exact (plus rare, verify-filtered hash collisions for wide windows), so the
reference's screen+sort+join collapses into one join.

Index layout (per target shard) — sized for 100M+ base databases, so every
array here is one the HBM budget pays for:

  tpacked    (S/8+pad,) uint32  nibble-packed gene stream (verify kernel)
  gene_start (G+1,) int32  gene offsets into the stream
  skeys      (V,)  uint32  window key of every *valid* window position,
                           sorted ascending (ties by position)
  skeys2     second hash word (zeros for width <= 13).  Host-side only on
             the default build: the sort-merge probe joins on key1 alone
             (collisions die in the byte-true verify), so the device
             carries a 1-element placeholder; the host copy feeds the
             search-probe aux and save().
  spos       (V,)  int32   the window positions, aligned with skeys

There is deliberately no per-base gene id array (4 bytes/base of HBM) —
the verify kernel recovers the owning gene of a hit position with a binary
search over gene_start (ops/packed.gene_of_pos).  The unique-key /
bucket-table view used by the binary-search probe is built lazily
(search_aux) because the default sort-merge probe never touches it.

A window position p is valid iff the whole window lies inside one gene:
no gene boundary falls strictly inside [p, p + W - 1], computed from a
cumulative boundary count (no per-base gene array needed).  The
reference's additional per-window constraint (window offset q1 must fit
left of the site, cmd/muscato_screen/main.go:340-346 `jw >= 0`) is
window-dependent and is enforced in the verify kernel instead, so one
index serves all windows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..io.targets import TargetSet
from ..ops import packed as pops
from ..ops import search as sops
from ..ops import windows as winops

INVALID_KEY = np.uint32(0xFFFFFFFF)

INDEX_FORMAT_VERSION = 2


DIRECT_BUCKET_WIDTH = 16  # max records fetched per direct probe
MAX_DIRECT_BITS = 26  # 268MB bucket-table cap


@dataclass
class SearchAux:
    """Unique-key view + bucket table for the search probe.

    Duplicate-key runs collapse to one entry so bucket depth tracks
    *distinct* keys.  Two probe modes:

    mode='direct' — the bucket table is sized so that NO bucket holds more
    than DIRECT_BUCKET_WIDTH distinct keys (possible whenever the key
    distribution is hash-uniform, which wide windows guarantee).  A probe
    is then exactly two dependent coalesced fetches: the bucket bounds
    (adjacent table entries, one burst) and the bucket's records — 16-byte
    interleaved (k1, k2, start, count) entries in `urec`, so equality
    check and postings arrive in the same burst.  No search loop at all.

    mode='binary' — fallback for skewed key distributions: per-bucket
    bounded binary search over `ukk` interleaved key pairs (round-1
    design, ~probe_steps dependent gather pairs per query).
    """

    mode: str
    sbucket: jnp.ndarray  # (2**bucket_bits+1,) int32 per-bucket bounds
    bucket_bits: int
    upshift: int
    # direct mode
    urec: jnp.ndarray | None = None  # (U*4 + pad,) uint32 [k1,k2,start,count]
    # binary mode
    ukeys: jnp.ndarray | None = None  # (U,) uint32
    ukeys2: jnp.ndarray | None = None  # (U,) uint32
    ustart: jnp.ndarray | None = None  # (U,) int32 run start in spos
    ucount: jnp.ndarray | None = None  # (U,) int32 run length
    ukk: jnp.ndarray | None = None  # (2U,) uint32 interleaved [k1,k2]
    probe_steps: int = 0


@dataclass
class TargetIndex:
    tpacked: jnp.ndarray  # nibble-packed stream for the SWAR verify kernel
    gene_start: jnp.ndarray  # (G+1,) int32
    skeys: jnp.ndarray
    skeys2: jnp.ndarray
    spos: jnp.ndarray
    width: int
    num_valid: int
    num_bases: int
    # Host copies of (skeys, skeys2, spos) — populated by the host build
    # and by load(); save() and search_aux() read these instead of pulling
    # 12 bytes/window back across the device link.
    host_arrays: tuple | None = field(default=None, repr=False)
    # Build-phase wall-time split (host keys+radix sort / nibble pack /
    # device upload), recorded by build_target_index so a slow build is
    # attributable from bench provenance alone.
    build_timings: dict | None = field(default=None, repr=False)
    _aux: SearchAux | None = field(default=None, repr=False)
    _trows: tuple | None = field(default=None, repr=False)
    _gblock: tuple | None = field(default=None, repr=False)

    @property
    def size(self) -> int:
        return self.num_bases

    def trows(self, nwords: int) -> jnp.ndarray:
        """Overlapping row view of tpacked for the row-gather verify (one
        row fetch per lane instead of one lookup per fetched word).  Built
        once per read word count; ~2.75x tpacked's bytes of extra device
        memory."""
        if self._trows is None or self._trows[0] != nwords:
            t = pops.build_trows(self.tpacked, nwords, self.num_bases)
            self._trows = (nwords, t)
        return self._trows[1]

    def gene_block(self) -> tuple:
        """(gblock device array, refine steps) for gene_of_pos_block —
        replaces the log2(G)-step binary search per verify lane."""
        if self._gblock is None:
            gs = np.asarray(self.gene_start)
            gb, steps = pops.build_gene_block(gs, self.num_bases)
            self._gblock = (jnp.asarray(gb), steps)
        return self._gblock

    def search_aux(self) -> SearchAux:
        """Build (once) the unique-key + bucket view for the search probe."""
        if self._aux is None:
            if self.host_arrays is not None:
                k1, k2, _ = self.host_arrays
            else:
                k1 = np.asarray(self.skeys)
                k2 = np.asarray(self.skeys2)
            new_run = np.concatenate(
                [[True], (k1[1:] != k1[:-1]) | (k2[1:] != k2[:-1])]
            )
            starts = np.flatnonzero(new_run).astype(np.int32)
            counts = np.diff(np.append(starts, len(k1))).astype(np.int32)
            uk1, uk2 = k1[starts], k2[starts]
            self._aux = build_search_aux(uk1, uk2, starts, counts, self.width)
        return self._aux

    def save(self, path: str) -> None:
        """Persist the sorted key arrays so later runs skip the build sort.

        tpacked/gene_start are cheap to recompute from the TargetSet and are
        not stored."""
        if self.host_arrays is not None:
            k1, k2, sp = self.host_arrays
        else:
            k1, k2, sp = (
                np.asarray(self.skeys), np.asarray(self.skeys2),
                np.asarray(self.spos),
            )
        np.savez(
            path,
            version=np.int64(INDEX_FORMAT_VERSION),
            width=np.int64(self.width),
            num_valid=np.int64(self.num_valid),
            num_bases=np.int64(self.num_bases),
            skeys=k1, skeys2=k2, spos=sp,
        )

    @classmethod
    def load(cls, path: str, ts: TargetSet, width: int) -> "TargetIndex":
        d = np.load(path)
        if int(d["version"]) != INDEX_FORMAT_VERSION:
            raise ValueError(f"index file {path}: unsupported version {int(d['version'])}")
        if int(d["width"]) != width or int(d["num_bases"]) != int(ts.gene_start[-1]):
            raise ValueError(
                f"index file {path} was built for a different width/target set"
            )
        k1, k2, sp = d["skeys"], d["skeys2"], d["spos"]
        return cls(
            tpacked=pops.pack_stream(np.asarray(ts.tcat)),
            gene_start=jnp.asarray(np.asarray(ts.gene_start, np.int64).astype(np.int32)),
            skeys=jnp.asarray(k1),
            skeys2=_skeys2_placeholder(),
            spos=jnp.asarray(sp),
            width=width,
            num_valid=int(d["num_valid"]),
            num_bases=int(d["num_bases"]),
            host_arrays=(k1, k2, sp),
        )


def build_search_aux(uk1, uk2, starts, counts, width: int) -> SearchAux:
    """Pick the search-probe layout for a unique-key table.

    Prefers 'direct': the smallest bucket table whose largest bucket holds
    at most DIRECT_BUCKET_WIDTH distinct keys.  Hash-uniform keys (wide
    windows) virtually always qualify at ~4 keys/bucket mean; heavily
    skewed distributions fall back to the bounded binary search."""
    u = len(uk1)
    upshift = sops.bucket_shift(width)
    scaled_all = (uk1.astype(np.uint64) << np.uint64(upshift)) >> np.uint64(32)
    # scaled_all is the key's top 32-bit image; bucket of key at `bits` is
    # its top `bits` bits.
    top32 = ((uk1.astype(np.uint64) << np.uint64(upshift)) & np.uint64(0xFFFFFFFF)).astype(
        np.uint32
    )
    del scaled_all
    start_bits = max(16, int(np.ceil(np.log2(max(u, 1) / 4 + 1))))
    for bits in range(start_bits, MAX_DIRECT_BITS + 1):
        b = (top32 >> np.uint32(32 - bits)).astype(np.int64)
        per = np.bincount(b, minlength=1 << bits)
        if int(per.max(initial=0)) <= DIRECT_BUCKET_WIDTH:
            bucket = np.zeros((1 << bits) + 1, np.int32)
            np.cumsum(per, out=bucket[1:])
            rec = np.empty((u, 4), np.uint32)
            rec[:, 0] = uk1
            rec[:, 1] = uk2
            rec[:, 2] = starts.astype(np.uint32)
            rec[:, 3] = counts.astype(np.uint32)
            pad = np.zeros((DIRECT_BUCKET_WIDTH, 4), np.uint32)
            pad[:, 0] = 0xFFFFFFFF  # never equal to a live query's key1+key2
            pad[:, 1] = 0xFFFFFFFF
            return SearchAux(
                mode="direct",
                sbucket=jnp.asarray(bucket),
                bucket_bits=bits,
                upshift=upshift,
                urec=jnp.asarray(np.concatenate([rec, pad]).reshape(-1)),
            )
    bucket, probe_steps, bucket_bits = sops.build_buckets_host(uk1, upshift)
    return SearchAux(
        mode="binary",
        sbucket=jnp.asarray(bucket),
        bucket_bits=bucket_bits,
        upshift=upshift,
        ukeys=jnp.asarray(uk1),
        ukeys2=jnp.asarray(uk2),
        ustart=jnp.asarray(starts),
        ucount=jnp.asarray(counts),
        ukk=jnp.asarray(np.stack([uk1, uk2], axis=1).reshape(-1)),
        probe_steps=probe_steps,
    )


def _boundary_cumsum_np(gene_start: np.ndarray, s: int) -> np.ndarray:
    """cum[x] = number of interior gene boundaries <= x (length S+1)."""
    b = np.zeros(s + 1, np.int32)
    interior = gene_start[1:-1]
    np.add.at(b, interior, 1)
    return np.cumsum(b, dtype=np.int32)


def _skeys2_placeholder() -> jnp.ndarray:
    """1-element stand-in for the device skeys2 array: the sort-merge
    probe traces but never uses it (key1-only join), and the search-probe
    aux is built from the host copies."""
    return jnp.zeros(1, dtype=jnp.uint32)


@partial(jax.jit, static_argnames=("width",))
def _index_arrays(tcat, gene_start, nreal, width):
    """Device index build: window keys at every position, validity from the
    gene-boundary structure, one 4-operand sort.

    nreal is the count of real (non-padding) bases; windows must end inside
    it.  Returns (skeys, skeys2, spos, nvalid)."""
    s = tcat.shape[0]
    keys = winops.sliding_window_keys(tcat, width)
    if winops.uses_second_key(width):
        keys2 = winops.sliding_window_keys(tcat, width, winops.HASH_MULT2)
    else:
        keys2 = jnp.zeros(s, dtype=jnp.uint32)
    pos = jnp.arange(s, dtype=jnp.int32)

    # cum[x] = interior boundaries <= x; a window [p, p+W-1] spans one gene
    # iff no boundary lies in (p, p+W-1].
    b = jnp.zeros(s + 1, jnp.int32)
    interior = jnp.clip(gene_start[1:-1], 0, s)
    b = b.at[interior].add(1)
    cum = jnp.cumsum(b)
    endc = jnp.minimum(pos + width - 1, s)
    crossing = cum[endc] - cum[pos]
    valid = (pos + width - 1 < nreal) & (crossing == 0)

    # Invalid slots sort to the top with an all-ones key; the valid prefix
    # is a contiguous sorted run.  (A real key may equal INVALID_KEY only
    # for hashed windows; invalid entries carry pos=-1 which the verify
    # kernel rejects, and the rank column keeps them after real entries.)
    sort_keys = jnp.where(valid, keys, jnp.uint32(INVALID_KEY))
    sort_keys2 = jnp.where(valid, keys2, jnp.uint32(INVALID_KEY))
    spos = jnp.where(valid, pos, jnp.int32(-1))
    invalid_rank = (~valid).astype(jnp.int32)
    skeys, skeys2, _rank, spos = jax.lax.sort(
        (sort_keys, sort_keys2, invalid_rank, spos), num_keys=4, dimension=0
    )
    nvalid = jnp.sum(valid.astype(jnp.int32))
    return skeys, skeys2, spos, nvalid


def _host_index_arrays(tcat: np.ndarray, gene_start: np.ndarray, width: int):
    """Host twin of _index_arrays — identical results, no XLA compile.

    The hot parts run in C when the native lib is present (one-pass window
    keys; LSD radix sort of the valid (k1, k2, pos) rows — ~10x
    np.lexsort, which made round 1's 100M-base build take 128s); numpy
    fallbacks cover the rest.  Only valid windows are sorted, so the
    sorted arrays are exactly the valid set (no invalid tail to trim)."""
    from ..io import native

    s = len(tcat)
    mult = np.uint32(winops.key_multiplier(width))
    use_k2 = winops.uses_second_key(width)
    m2 = np.uint32(winops.HASH_MULT2) if use_k2 else np.uint32(0)
    keys = np.empty(s, np.uint32)
    keys2 = np.zeros(s, np.uint32)
    tcat_c = np.ascontiguousarray(tcat, dtype=np.uint8)
    if not native.window_keys_native(tcat_c, width, mult, m2, keys, keys2):
        padded = np.concatenate(
            [tcat.astype(np.uint32), np.zeros(width - 1, np.uint32)]
        )
        with np.errstate(over="ignore"):
            keys[:] = 0
            for i in range(width):
                keys *= mult
                keys += padded[i : i + s]
            if use_k2:
                keys2[:] = 0
                for i in range(width):
                    keys2 *= m2
                    keys2 += padded[i : i + s]
    pos = np.arange(s, dtype=np.int32)
    cum = _boundary_cumsum_np(gene_start, s)
    endc = np.minimum(pos + width - 1, s)
    crossing = cum[endc] - cum[pos]
    valid = (pos + width - 1 < s) & (crossing == 0)
    nvalid = int(valid.sum())

    k1 = np.ascontiguousarray(keys[valid])
    k2 = np.ascontiguousarray(keys2[valid])
    spos = np.ascontiguousarray(pos[valid])
    if not native.sort_index_native(k1, k2, spos):
        order = np.lexsort((spos, k2, k1))
        k1, k2, spos = k1[order], k2[order], spos[order]
    return k1, k2, spos, nvalid


def build_target_index(
    ts: TargetSet, width: int, device_build: bool = False
) -> TargetIndex:
    """Compile a TargetSet into a device-resident TargetIndex.

    The default host build runs the window keys and the (k1, k2, pos)
    radix sort in C (native lib) — seconds per 100M bases, no XLA compile
    — and uploads the sorted arrays once.  device_build=True computes and
    sorts on the accelerator instead (no index upload; worth it when host
    cores are scarce and the one-time compile is amortized)."""
    import time as _time

    s = int(ts.gene_start[-1])
    gene_start64 = np.asarray(ts.gene_start, dtype=np.int64)
    if s > np.iinfo(np.int32).max:
        raise NotImplementedError(
            "single-shard target index limited to 2**31-1 positions; "
            "shard by gene range (muscato_tpu.parallel) for larger databases"
        )
    gene_start_np = gene_start64.astype(np.int32)
    gene_start = jnp.asarray(gene_start_np)
    t0 = _time.perf_counter()
    if device_build:
        tcat = jnp.asarray(np.asarray(ts.tcat, dtype=np.uint8))
        skeys, skeys2, spos, nvalid = _index_arrays(
            tcat, gene_start, jnp.int32(s), width
        )
        nvalid = int(nvalid)
        del tcat
        # Drop the invalid tail: it would pile into the last search bucket
        # and inflate the probe's worst-case depth.
        nkeep = max(1, nvalid)
        skeys, skeys2, spos = skeys[:nkeep], skeys2[:nkeep], spos[:nkeep]
    else:
        k1, k2, sp, nvalid = _host_index_arrays(
            np.asarray(ts.tcat), gene_start_np, width
        )
        if nvalid == 0:
            k1 = np.array([INVALID_KEY], np.uint32)
            k2 = np.array([INVALID_KEY], np.uint32)
            sp = np.array([-1], np.int32)
        t_host = _time.perf_counter()
        skeys = jnp.asarray(k1)
        # The sort-merge probe joins on key1 alone (ops/fused.py — key2
        # collisions are resolved by the byte-true verify), so the second
        # key word never goes to the device: the host copy serves the
        # search-probe aux build and save(); the device placeholder saves
        # 4 bytes/window of HBM and upload.
        skeys2 = _skeys2_placeholder()
        spos = jnp.asarray(sp)
        host_arrays = (k1, k2, sp)

    t_pack0 = _time.perf_counter()
    tpacked = pops.pack_stream(np.asarray(ts.tcat))
    t_pack = _time.perf_counter()
    timings = None
    if not device_build:
        # Force the uploads to completion so the split is honest (the
        # asarray dispatches above are async); callers that would have
        # paid this at first use pay it here instead.
        skeys.block_until_ready()
        spos.block_until_ready()
        tpacked.block_until_ready()
        timings = {
            "host_keys_sort_s": round(t_host - t0, 3),
            "pack_s": round(t_pack - t_pack0, 3),
            # asarray dispatch before the pack + the blocking wait after.
            "upload_s": round(
                (t_pack0 - t_host) + (_time.perf_counter() - t_pack), 3
            ),
        }

    return TargetIndex(
        tpacked=tpacked,
        gene_start=gene_start,
        skeys=skeys,
        skeys2=skeys2,
        spos=spos,
        width=width,
        num_valid=nvalid,
        num_bases=s,
        host_arrays=None if device_build else host_arrays,
        build_timings=timings,
    )
