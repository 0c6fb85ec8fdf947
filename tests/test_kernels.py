"""Device-op unit tests and engine-vs-oracle fuzzing."""

import random

import numpy as np
import pytest

from muscato_tpu.config import Config
from muscato_tpu.engine import pipeline
from muscato_tpu.engine.index import build_target_index
from muscato_tpu.io import seqcodec
from muscato_tpu.io.reads import ReadSet
from muscato_tpu.io.targets import TargetSet
from muscato_tpu.ops import verify as vops
from muscato_tpu.ops import windows as winops

from oracle import oracle_match

import jax.numpy as jnp


# ---------------------------------------------------------------- packing ---


def test_window_keys_exact_width():
    # width <= 13: the key is the exact base-5 packing.
    codes, _ = seqcodec.encode_rows([b"ACGTX"], 5)
    key = np.asarray(winops.window_keys_at(jnp.asarray(codes), 0, 5))[0]
    assert key == ((((0 * 5 + 1) * 5 + 2) * 5 + 3) * 5 + 4)


def test_sliding_vs_rowwise_keys():
    rng = np.random.default_rng(0)
    t = rng.integers(0, 5, size=100).astype(np.uint8)
    for width in [4, 13, 20]:
        skeys = np.asarray(winops.sliding_window_keys(jnp.asarray(t), width))
        for p in range(0, 100 - width + 1):
            row = jnp.asarray(t[p : p + width][None, :])
            rk = np.asarray(winops.window_keys_at(row, 0, width))[0]
            assert skeys[p] == rk, (p, width)


def test_dinucleotide_counts_matches_scalar():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 5, size=(50, 12)).astype(np.uint8)
    got = np.asarray(winops.dinucleotide_counts(jnp.asarray(codes), 2, 8))
    for i in range(50):
        assert got[i] == seqcodec.dinucleotide_count(codes[i, 2:10])


def test_mismatch_budget_truncation():
    # Same float64 dance as Go: (1-0.96)*100 = 4.000000000000004 -> 4
    tab = vops.mismatch_budget_table(0.96, 200)
    assert tab[100] == 4
    assert tab[0] == 0
    assert tab[25] == 1  # 0.04*25 = 1.0000000000000009 -> 1
    tab1 = vops.mismatch_budget_table(1.0, 50)
    assert tab1.max() == 0


# ------------------------------------------------------------------- fuzz ---


def _mk_readset(reads):
    lmax = max((len(r) for r in reads), default=1)
    codes, lengths = seqcodec.encode_rows([r.encode() for r in reads], lmax)
    return ReadSet(
        codes=codes,
        lengths=lengths,
        counts=np.ones(len(reads), dtype=np.int64),
        names=[b"r%d" % i for i in range(len(reads))],
        seqs=[r.encode() for r in reads],
        num_total=len(reads),
    ), lmax


def _mk_targetset(genes):
    gene_start = np.zeros(len(genes) + 1, dtype=np.int64)
    for i, g in enumerate(genes):
        gene_start[i + 1] = gene_start[i] + len(g)
    if genes:
        tcat = np.concatenate([seqcodec.encode(g.encode()) for g in genes])
    else:
        tcat = np.zeros(0, np.uint8)
    return TargetSet(
        tcat=tcat.astype(np.uint8),
        gene_start=gene_start,
        names=[b"g%d" % i for i in range(len(genes))],
        lengths=np.diff(gene_start),
    )


def _run_engine(reads, genes, windows, width, pmatch, min_dinuc, max_rl, mmtol,
                probe=None):
    rs, lmax = _mk_readset(reads)
    # Engine pads reads to MaxReadLength; emulate prep by re-padding.
    codes = np.zeros((len(reads), max_rl), dtype=np.uint8)
    codes[:, :lmax] = rs.codes[:, :lmax]
    rs.codes = codes
    ts = _mk_targetset(genes)
    cfg = Config(
        Windows=list(windows), WindowWidth=width, PMatch=pmatch,
        MinDinuc=min_dinuc, MaxReadLength=max_rl, MMTol=mmtol,
        MaxMatches=10**6, MatchMode="best",
    )
    if probe is None:
        mr = pipeline.run_matching(cfg, rs, ts)
    else:
        index = build_target_index(ts, width)
        mr = pipeline.run_matching_indexed(cfg, rs, index, probe=probe)
    return {
        (int(r), int(g), int(s), int(nx))
        for r, g, s, nx in zip(mr.read_row, mr.gene, mr.start, mr.nmiss)
    }


ALPHA = "ACGT"
ALPHAX = "ACGTX"


# Seeds whose draws seed every window with at least one read (the engine
# aborts on an empty window by contract, so such draws cannot be compared).
FUZZ_SEEDS = (0, 1, 2, 3, 4, 5, 7, 8)


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
@pytest.mark.parametrize("dorder", [False, True])
@pytest.mark.parametrize("probe", ["sort", "search"])
def test_fuzz_engine_matches_oracle(probe, dorder, seed, monkeypatch):
    from muscato_tpu.ops import fused

    monkeypatch.setattr(fused, "_DORDER", [dorder])
    rng = random.Random(seed)
    width = rng.choice([3, 4, 5, 8, 14, 16])  # incl. hashed-key widths > 13
    nwin = rng.randint(1, 3)
    windows = sorted(rng.sample(range(0, 12), nwin))
    max_rl = rng.choice([20, 30, 120])
    pmatch = rng.choice([1.0, 0.9, 0.8, 0.5])
    min_dinuc = rng.choice([0, 1, 2])
    mmtol = rng.choice([0, 1, 3])
    alpha = ALPHAX if rng.random() < 0.4 else ALPHA

    # Build genes, then derive some reads from gene fragments (guaranteeing
    # near-matches), plus random reads.
    genes = [
        "".join(rng.choice(alpha) for _ in range(rng.randint(width, 60)))
        for _ in range(rng.randint(1, 8))
    ]
    reads = []
    for _ in range(rng.randint(1, 12)):
        if rng.random() < 0.7 and genes:
            g = rng.choice(genes)
            if len(g) >= width + 1:
                a = rng.randrange(0, len(g) - width)
                b = rng.randrange(a + width, min(len(g), a + max_rl) + 1)
                frag = list(g[a:b])
                for _ in range(rng.randint(0, 2)):  # sprinkle mismatches
                    frag[rng.randrange(len(frag))] = rng.choice(alpha)
                reads.append("".join(frag))
                continue
        reads.append("".join(rng.choice(alpha) for _ in range(rng.randint(width, 25))))
    reads = [r[:max_rl] for r in reads]

    exp = oracle_match(reads, genes, windows, width, pmatch, min_dinuc, max_rl, mmtol)

    # The engine aborts when a window seeds no reads (reference behavior);
    # the oracle has no such abort, so FUZZ_SEEDS avoids those draws.
    for q1 in windows:
        assert any(
            len(r) >= q1 + width
            and __import__("oracle").dinuc_count(r[q1 : q1 + width]) >= min_dinuc
            for r in reads
        ), f"seed {seed} seeds no reads in window {q1}; pick another seed"

    got = _run_engine(reads, genes, windows, width, pmatch, min_dinuc, max_rl,
                      mmtol, probe=probe)
    assert got == exp, (
        f"probe={probe} dorder={dorder} seed={seed} width={width} "
        f"windows={windows} pmatch={pmatch} "
        f"min_dinuc={min_dinuc} mmtol={mmtol}\nonly_engine={got-exp}\nonly_oracle={exp-got}"
    )


@pytest.mark.parametrize("seed", range(4))
def test_dedup_verify_equals_streaming(seed):
    """The diagonal-dedup expand path (verify once per (read, diagonal))
    must emit exactly the streaming path's matches — including when
    several windows of one read land on the same diagonal (the case the
    dedup collapses) and when the pos-0 cap quirk binds on one window of
    a shared diagonal."""
    rng = random.Random(1000 + seed)
    width = rng.choice([4, 6, 14])
    windows = sorted(rng.sample(range(0, 10), rng.randint(2, 4)))
    max_rl = rng.choice([30, 140])
    genes = [
        "".join(rng.choice(ALPHAX) for _ in range(rng.randint(width, 80)))
        for _ in range(rng.randint(1, 6))
    ]
    reads = []
    for _ in range(rng.randint(2, 10)):
        if rng.random() < 0.8 and genes:
            g = rng.choice(genes)
            if len(g) >= width + max(windows) + 1:
                a = rng.randrange(0, len(g) - width - max(windows))
                b = rng.randrange(a + width, min(len(g), a + max_rl) + 1)
                reads.append(g[a:b])
                continue
        reads.append(
            "".join(rng.choice(ALPHAX) for _ in range(rng.randint(width, 25)))
        )
    reads = [r[:max_rl] for r in reads]

    def _run(no_dedup):
        rs, lmax = _mk_readset(reads)
        codes = np.zeros((len(reads), max_rl), dtype=np.uint8)
        codes[:, :lmax] = rs.codes[:, :lmax]
        rs.codes = codes
        ts = _mk_targetset(genes)
        cfg = Config(
            Windows=list(windows), WindowWidth=width, PMatch=0.9,
            MinDinuc=0, MaxReadLength=max_rl, MMTol=2,
            MaxMatches=10**6, MatchMode="best", NoDedup=no_dedup,
        )
        try:
            mr = pipeline.run_matching(cfg, rs, ts)
        except SystemExit:
            return None  # a window seeded no reads; both paths abort alike
        return {
            (int(r), int(g), int(s), int(nx))
            for r, g, s, nx in zip(mr.read_row, mr.gene, mr.start, mr.nmiss)
        }

    assert _run(False) == _run(True)


def test_dedup_verify_pos0_shared_diagonal():
    """Windows 0 and 4 both hit diagonal 0 of a long read at gene start:
    the pos-0 cap must suppress only window 0's pair, and the dedup path
    must still emit the window-4 match for the same (read, diagonal)."""
    width = 8
    read = "".join("ACGT"[(i * 7 + 3) % 4] for i in range(120))
    gene = read + "ACGTACGT" * 5
    for no_dedup in (False, True):
        rs, lmax = _mk_readset([read])
        codes = np.zeros((1, 200), dtype=np.uint8)
        codes[:, :lmax] = rs.codes[:, :lmax]
        rs.codes = codes
        ts = _mk_targetset([gene])
        cfg = Config(
            Windows=[0, 4], WindowWidth=width, PMatch=1.0, MinDinuc=0,
            MaxReadLength=200, MMTol=0, MaxMatches=10**6,
            MatchMode="best", NoDedup=no_dedup,
        )
        mr = pipeline.run_matching(cfg, rs, ts)
        got = {
            (int(r), int(g), int(s), int(nx))
            for r, g, s, nx in zip(mr.read_row, mr.gene, mr.start, mr.nmiss)
        }
        # Window 4 rescues the diagonal the pos-0 cap kills for window 0.
        assert got == {(0, 0, 0, 0)}, (no_dedup, got)


def test_pos0_quirk_long_read():
    """A read longer than 100 matching at target position 0 via window
    offset 0 is dropped (the reference's hard-coded jz=100-q2 right-tail
    cap, cmd/muscato_screen/main.go:305), but found at position > 0."""
    width = 8
    read = "".join("ACGT"[(i * 7 + 3) % 4] for i in range(120))
    gene_hit_at_0 = read + "ACGTACGT" * 5  # read at p_local 0
    gene_hit_at_2 = "GG" + read + "ACGTACGT" * 5  # read at p_local 2
    got = _run_engine(
        [read], [gene_hit_at_0, gene_hit_at_2], [0], width, 1.0, 0, 200, 0
    )
    exp = oracle_match(
        [read], [gene_hit_at_0, gene_hit_at_2], [0], width, 1.0, 0, 200, 0
    )
    assert got == exp
    assert (0, 1, 2, 0) in got  # found at offset 2
    assert (0, 0, 0, 0) not in got  # suppressed by the pos-0 cap


def test_packed_verify_matches_byte_verify():
    """SWAR packed verify must be bit-identical to the byte-path verify."""
    import jax.numpy as jnp
    from muscato_tpu.ops import packed as pops

    rng = np.random.default_rng(42)
    n_pairs = 512
    max_rl = 64
    width = 7
    for q1 in [0, 3, 9]:
        S = 4000
        tcat = rng.integers(0, 5, S).astype(np.uint8)
        gene_start = np.array([0, 1500, 2250, S], dtype=np.int32)
        codes = rng.integers(0, 5, (100, max_rl)).astype(np.uint8)
        lengths = rng.integers(width + q1, max_rl + 1, 100).astype(np.int32)
        for i in range(100):  # zero the padding
            codes[i, lengths[i]:] = 0
        # Make some pairs true matches at their diagonals.
        r = rng.integers(0, 100, n_pairs).astype(np.int32)
        p = rng.integers(0, S - width, n_pairs).astype(np.int32)
        for i in range(0, n_pairs, 3):
            d = p[i] - q1
            if d >= 0 and d + lengths[r[i]] <= S:
                codes[r[i], : lengths[r[i]]] = tcat[d : d + lengths[r[i]]]
        r[::17] = -1  # inactive lanes
        budget = vops.mismatch_budget_table(0.9, max_rl)

        args_common = (
            jnp.asarray(gene_start), jnp.asarray(budget), q1, width, max_rl,
        )
        kb, nxb, gb, sb = vops.verify_pairs_dynq(
            jnp.asarray(r), jnp.asarray(p), jnp.asarray(codes),
            jnp.asarray(lengths), jnp.asarray(tcat), *args_common,
        )
        rpacked = pops.pack_rows(jnp.asarray(codes))
        tpacked = pops.pack_stream(tcat)
        kp, nxp, gp, sp = pops.verify_pairs_packed(
            jnp.asarray(r), jnp.asarray(p), rpacked,
            jnp.asarray(lengths), tpacked, *args_common, S,
        )
        np.testing.assert_array_equal(np.asarray(kb), np.asarray(kp))
        np.testing.assert_array_equal(
            np.asarray(nxb)[np.asarray(kb)], np.asarray(nxp)[np.asarray(kp)]
        )
        np.testing.assert_array_equal(np.asarray(gb), np.asarray(gp))
        np.testing.assert_array_equal(np.asarray(sb), np.asarray(sp))


def test_rowgather_verify_matches_elem_verify():
    """The row-gather target fetch (trows view) and block gene table must
    give bit-identical verify results to the element-gather/binary-search
    path, including at stream edges and gene boundaries."""
    import jax.numpy as jnp
    from muscato_tpu.ops import packed as pops

    rng = np.random.default_rng(7)
    max_rl = 72
    width = 9
    S = 5000
    # Irregular gene sizes, including tiny genes (stress the block table).
    cuts = np.sort(rng.choice(np.arange(1, S), 40, replace=False))
    gene_start = np.concatenate([[0], cuts, [S]]).astype(np.int32)
    tcat = rng.integers(0, 5, S).astype(np.uint8)
    codes = rng.integers(0, 5, (64, max_rl)).astype(np.uint8)
    lengths = rng.integers(width, max_rl + 1, 64).astype(np.int32)
    for i in range(64):
        codes[i, lengths[i]:] = 0
    budget = jnp.asarray(vops.mismatch_budget_table(0.9, max_rl))
    rpacked = pops.pack_rows(jnp.asarray(codes))
    tpacked = pops.pack_stream(tcat)
    gs = jnp.asarray(gene_start)
    trows = pops.build_trows(tpacked, int(rpacked.shape[1]), S)
    gb_np, steps = pops.build_gene_block(gene_start, S)
    gblock = jnp.asarray(gb_np)

    n = 2048
    r = rng.integers(0, 64, n).astype(np.int32)
    # Diagonals across the whole stream, incl. first/last positions.
    d = rng.integers(0, S, n).astype(np.int32)
    d[:4] = [0, 1, S - 1, S - 2]
    r[::19] = -1
    q1s = jnp.asarray(np.array([0, 2, 11], np.int32))

    base = pops.verify_diagonals_packed(
        jnp.asarray(r), jnp.asarray(d), rpacked, jnp.asarray(lengths),
        tpacked, gs, budget, q1s, width, max_rl, S,
    )
    rows = pops.verify_diagonals_packed(
        jnp.asarray(r), jnp.asarray(d), rpacked, jnp.asarray(lengths),
        tpacked, gs, budget, q1s, width, max_rl, S,
        trows=trows, gblock=gblock, gsteps=steps,
    )
    for a, b in zip(base, rows):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    p = rng.integers(0, S - width, n).astype(np.int32)
    p[::13] = -1
    for q1 in (0, 5):
        kb = pops.verify_pairs_packed(
            jnp.asarray(r), jnp.asarray(p), rpacked, jnp.asarray(lengths),
            tpacked, gs, budget, q1, width, max_rl, S,
        )
        kr = pops.verify_pairs_packed(
            jnp.asarray(r), jnp.asarray(p), rpacked, jnp.asarray(lengths),
            tpacked, gs, budget, q1, width, max_rl, S,
            trows=trows, gblock=gblock, gsteps=steps,
        )
        for a, b in zip(kb, kr):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_max_matches_cap_binds():
    """When a k-mer group exceeds MaxMatches, 'best' keeps the lowest-nmiss
    matches (deterministically here; the reference truncates approximately,
    cmd/muscato_confirm/main.go:424-448)."""
    # One read; one gene containing the read's window k-mer at many sites,
    # with varying tail mismatches.
    width = 4
    kmer = "ACGT"
    read = kmer + "AAAA"  # window at q1=0, right tail AAAA
    sites = []
    for i in range(6):
        tail = ["AAAA", "AAAT", "AATT", "ATTT", "TTTT", "AAAG"][i]
        sites.append(kmer + tail)
    gene = "GG".join(sites)  # separate sites so diagonals differ
    cfg_kwargs = dict(windows=[0], width=width, pmatch=0.0, min_dinuc=0,
                      max_rl=20, mmtol=10)

    full = _run_engine([read], [gene], **cfg_kwargs)
    assert len(full) == 6

    # Cap at 3: keep the 3 best (fewest-mismatch) sites.
    rs, lmax = _mk_readset([read])
    codes = np.zeros((1, 20), dtype=np.uint8)
    codes[:, :lmax] = rs.codes[:, :lmax]
    rs.codes = codes
    ts = _mk_targetset([gene])
    cfg = Config(Windows=[0], WindowWidth=width, PMatch=0.0, MinDinuc=0,
                 MaxReadLength=20, MMTol=10, MaxMatches=3, MatchMode="best")
    mr = pipeline.run_matching(cfg, rs, ts)
    got = sorted(zip(mr.nmiss.tolist(), mr.start.tolist()))
    best3 = sorted(nx for nx, _, in
                   [(nx, s) for (_, _, s, nx) in full])[:3]
    assert [nx for nx, _ in got] == best3

    # 'first' emits MaxMatches+1: the reference appends, then checks
    # len(qvals) > MaxMatches (cmd/muscato_confirm/main.go:236-238), so the
    # breaching match has already been written.
    cfg.MatchMode = "first"
    mr2 = pipeline.run_matching(cfg, rs, ts)
    assert len(mr2.read_row) == 4


def test_search_probe_equals_sort_probe():
    """The bucketed-search probe must produce the same survivors as the
    sort-merge probe (it is auto-selected only for huge indexes, so force
    it here)."""
    import jax.numpy as jnp
    from muscato_tpu.engine.index import build_target_index
    from muscato_tpu.ops import fused, packed as pops
    from muscato_tpu.ops import verify as vops

    rng = np.random.default_rng(5)
    genes = ["".join("ACGT"[i] for i in rng.integers(0, 4, 200)) for _ in range(20)]
    reads = []
    for _ in range(50):
        g = genes[int(rng.integers(20))]
        a = int(rng.integers(0, 150))
        reads.append(g[a : a + int(rng.integers(20, 50))])
    width, max_rl = 14, 64  # wide => dual hash keys
    rs, lmax = _mk_readset(reads)
    codes = np.zeros((len(reads), max_rl), dtype=np.uint8)
    codes[:, :lmax] = rs.codes[:, :lmax]
    ts = _mk_targetset(genes)
    idx = build_target_index(ts, width)

    codes_j = jnp.asarray(codes)
    rpacked = pops.pack_rows(codes_j)
    lengths = jnp.asarray(rs.lengths)
    budget = jnp.asarray(vops.mismatch_budget_table(0.9, max_rl))
    q1s = jnp.asarray(np.array([0, 7], np.int32))
    kw = dict(width=width, min_dinuc=1, max_read_length=max_rl,
              pair_chunk=1 << 12, surv_cap=1 << 12, smax=idx.num_bases)
    args = (rpacked, lengths, q1s, idx.skeys, idx.spos,
            idx.tpacked, idx.gene_start, budget)

    buf_a, n_a, t_a, _ = fused.match_windows(*args, **kw)
    buf_b, n_b, t_b, _ = fused.match_windows(*args, **kw, index_aux=idx.search_aux())

    assert int(n_a) == int(n_b)
    assert int(t_a) == int(t_b)
    rows_a = {tuple(r) for r in np.asarray(buf_a)[: int(n_a)].tolist()}
    rows_b = {tuple(r) for r in np.asarray(buf_b)[: int(n_b)].tolist()}
    assert rows_a == rows_b
    assert int(n_a) > 0


def test_direct_probe_mode_selected_and_equal():
    """Hash-uniform keys get the direct-bucket probe; its survivors equal
    the sort-merge probe's."""
    import jax.numpy as jnp
    from muscato_tpu.engine.index import build_target_index
    from muscato_tpu.ops import fused, packed as pops
    from muscato_tpu.ops import verify as vops

    rng = np.random.default_rng(9)
    genes = ["".join("ACGT"[i] for i in rng.integers(0, 4, 300)) for _ in range(30)]
    reads = []
    for _ in range(80):
        g = genes[int(rng.integers(30))]
        a = int(rng.integers(0, 250))
        reads.append(g[a : a + int(rng.integers(20, 50))])
    width, max_rl = 16, 64
    rs, lmax = _mk_readset(reads)
    codes = np.zeros((len(reads), max_rl), dtype=np.uint8)
    codes[:, :lmax] = rs.codes[:, :lmax]
    ts = _mk_targetset(genes)
    idx = build_target_index(ts, width)
    aux = idx.search_aux()
    assert aux.mode == "direct"

    codes_j = jnp.asarray(codes)
    rpacked = pops.pack_rows(codes_j)
    lengths = jnp.asarray(rs.lengths)
    budget = jnp.asarray(vops.mismatch_budget_table(0.9, max_rl))
    q1s = jnp.asarray(np.array([0, 7], np.int32))
    kw = dict(width=width, min_dinuc=1, max_read_length=max_rl,
              pair_chunk=1 << 12, surv_cap=1 << 12, smax=idx.num_bases)
    args = (rpacked, lengths, q1s, idx.skeys, idx.spos,
            idx.tpacked, idx.gene_start, budget)
    buf_a, n_a, t_a, _ = fused.match_windows(*args, **kw)
    buf_b, n_b, t_b, _ = fused.match_windows(*args, **kw, index_aux=aux)
    assert int(n_a) == int(n_b) and int(t_a) == int(t_b)
    rows_a = {tuple(r) for r in np.asarray(buf_a)[: int(n_a)].tolist()}
    rows_b = {tuple(r) for r in np.asarray(buf_b)[: int(n_b)].tolist()}
    assert rows_a == rows_b and int(n_a) > 0


def test_binary_probe_fallback_on_skewed_keys():
    """Skewed exact-width keys (all in one bucket) fall back to the binary
    probe and still match the sort-merge probe."""
    import jax.numpy as jnp
    from muscato_tpu.engine.index import build_target_index
    from muscato_tpu.ops import fused, packed as pops
    from muscato_tpu.ops import verify as vops

    rng = np.random.default_rng(21)
    # width-13 windows that are all 'A'*10 + 3 random chars: every distinct
    # key is a tiny base-5 number -> one bucket holds them all.
    genes = []
    for _ in range(40):
        tail = "".join("ACGT"[i] for i in rng.integers(0, 4, 3))
        genes.append("A" * 10 + tail + "A" * 10 + tail)
    reads = [g[:20] for g in genes[:25]]
    width, max_rl = 13, 32
    rs, lmax = _mk_readset(reads)
    codes = np.zeros((len(reads), max_rl), dtype=np.uint8)
    codes[:, :lmax] = rs.codes[:, :lmax]
    ts = _mk_targetset(genes)
    idx = build_target_index(ts, width)
    aux = idx.search_aux()
    assert aux.mode == "binary"

    codes_j = jnp.asarray(codes)
    rpacked = pops.pack_rows(codes_j)
    lengths = jnp.asarray(rs.lengths)
    budget = jnp.asarray(vops.mismatch_budget_table(1.0, max_rl))
    q1s = jnp.asarray(np.array([0], np.int32))
    kw = dict(width=width, min_dinuc=0, max_read_length=max_rl,
              pair_chunk=1 << 12, surv_cap=1 << 12, smax=idx.num_bases)
    args = (rpacked, lengths, q1s, idx.skeys, idx.spos,
            idx.tpacked, idx.gene_start, budget)
    buf_a, n_a, _, _ = fused.match_windows(*args, **kw)
    buf_b, n_b, _, _ = fused.match_windows(*args, **kw, index_aux=aux)
    rows_a = {tuple(r) for r in np.asarray(buf_a)[: int(n_a)].tolist()}
    rows_b = {tuple(r) for r in np.asarray(buf_b)[: int(n_b)].tolist()}
    assert rows_a == rows_b and int(n_a) > 0


def test_gene_sharded_single_device_equals_whole():
    """Sequential gene-range sharding (the >2**31-position path) must give
    identical results to the single-index run."""
    rng = np.random.default_rng(17)
    genes = ["".join("ACGT"[i] for i in rng.integers(0, 4, 120)) for _ in range(13)]
    reads = []
    for _ in range(30):
        g = genes[int(rng.integers(13))]
        a = int(rng.integers(0, 80))
        reads.append(g[a : a + 30])
    width, max_rl = 6, 40
    rs, lmax = _mk_readset(reads)
    codes = np.zeros((len(reads), max_rl), dtype=np.uint8)
    codes[:, :lmax] = rs.codes[:, :lmax]
    rs.codes = codes
    ts = _mk_targetset(genes)
    cfg = Config(
        Windows=[0, 4], WindowWidth=width, PMatch=0.9, MinDinuc=1,
        MaxReadLength=max_rl, MMTol=1, MaxMatches=10**6, MatchMode="best",
    )
    whole = pipeline.run_matching(cfg, rs, ts)
    exp = set(zip(whole.read_row.tolist(), whole.gene.tolist(),
                  whole.start.tolist(), whole.nmiss.tolist()))
    sharded = pipeline.run_matching_gene_sharded(cfg, rs, ts, 4)
    got = set(zip(sharded.read_row.tolist(), sharded.gene.tolist(),
                  sharded.start.tolist(), sharded.nmiss.tolist()))
    assert got == exp and len(got) > 0


def test_packed_fetch_roundtrip():
    """_pack_rows64 (device) and _unpack_rows64 (host) are inverses,
    including fields straddling the 32-bit word seam."""
    from muscato_tpu.ops import fused

    rng = np.random.default_rng(23)
    for bits in [(22, 17, 10, 4), (20, 20, 20, 4), (31, 11, 11, 11), (1, 1, 1, 1)]:
        rb, gb, sb, xb = bits
        n = 257
        r = rng.integers(0, 1 << rb, n).astype(np.int32)
        g = rng.integers(0, 1 << gb, n).astype(np.int32)
        s = rng.integers(0, 1 << sb, n).astype(np.int32)
        nx = rng.integers(0, 1 << xb, n).astype(np.int32)
        packed = np.asarray(
            fused._pack_rows64(
                jnp.asarray(r), jnp.asarray(g), jnp.asarray(s),
                jnp.asarray(nx), bits,
            )
        )
        out = pipeline._unpack_rows64(packed, bits)
        assert np.array_equal(out[:, 0], r)
        assert np.array_equal(out[:, 1], g)
        assert np.array_equal(out[:, 2], s)
        assert np.array_equal(out[:, 3], nx)


def test_dedup_pair_cap_regrow_and_fallback(monkeypatch):
    """A batch with far more pairs than the configured floor must (a) get
    an exactly-sized pair buffer from the probe total and produce exact
    results, and (b) fall back to the streaming expand+verify past the
    materialization ceiling — again with exact results."""
    # One 6-mer repeated across every gene and read: pairs = queries x
    # positions, far beyond a 1<<10 starting cap.
    unit = "ACGTCA"
    genes = [unit * 30 for _ in range(8)]  # 8 genes x 175 valid positions
    reads = [unit * 3 for _ in range(40)]
    rs, lmax = _mk_readset(reads)
    ts = _mk_targetset(genes)
    cfg = Config(
        Windows=[0, 6], WindowWidth=6, PMatch=0.9, MinDinuc=0,
        MaxReadLength=30, MMTol=2, MaxMatches=10**6, MatchMode="best",
    )
    expected = pipeline.run_matching(cfg, rs, ts)
    exp = set(zip(expected.read_row.tolist(), expected.gene.tolist(),
                  expected.start.tolist(), expected.nmiss.tolist()))
    assert len(exp) > 0

    # (a) tiny floor: the pair buffer is sized exactly from the probe's
    # total (the ~56k pairs fit a 2**16 power-of-two bucket, not the floor).
    monkeypatch.setattr(pipeline, "_PAIR_FLOOR", 1 << 10)
    monkeypatch.setattr(pipeline, "_MAX_PAIR_CAP", 1 << 26)
    mr = pipeline.run_matching(cfg, rs, ts)
    got = set(zip(mr.read_row.tolist(), mr.gene.tolist(),
                  mr.start.tolist(), mr.nmiss.tolist()))
    assert got == exp

    # (b) ceiling below the pair count: the batch must stream instead.
    monkeypatch.setattr(pipeline, "_PAIR_FLOOR", 1 << 10)
    monkeypatch.setattr(pipeline, "_MAX_PAIR_CAP", 1 << 12)
    mr = pipeline.run_matching(cfg, rs, ts)
    got = set(zip(mr.read_row.tolist(), mr.gene.tolist(),
                  mr.start.tolist(), mr.nmiss.tolist()))
    assert got == exp


def test_packed_window_queries_equal_codes_path():
    """The packed-word window-key extraction (the product probe path) must
    agree exactly with the byte-matrix reference implementation on keys,
    second hashes, and validity — including short rows, X codes, and
    windows straddling word boundaries."""
    import jax.numpy as jnp
    from muscato_tpu.ops import fused, packed as pops

    rng = np.random.default_rng(77)
    for width, min_dinuc, lmax in [(8, 0, 37), (13, 2, 100), (20, 3, 100), (4, 1, 9)]:
        nreads = 513
        codes = rng.integers(0, 5, (nreads, lmax)).astype(np.uint8)
        lengths = rng.integers(0, lmax + 1, nreads).astype(np.int32)
        for i in range(nreads):
            codes[i, lengths[i]:] = 0
        q1s = np.array([0, 3, 8, max(lmax - width, 0)], np.int32)

        k1_c, k2_c, v_c = fused._window_queries_codes(
            jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(q1s),
            width=width, min_dinuc=min_dinuc,
        )
        rpacked = jnp.asarray(pops.pack_rows_np(codes))
        k1_p, k2_p, v_p = fused._window_queries(
            rpacked, jnp.asarray(lengths), jnp.asarray(q1s),
            width=width, min_dinuc=min_dinuc,
        )
        v_c = np.asarray(v_c)
        np.testing.assert_array_equal(v_c, np.asarray(v_p))
        np.testing.assert_array_equal(np.asarray(k1_c)[v_c], np.asarray(k1_p)[v_c])
        np.testing.assert_array_equal(np.asarray(k2_c)[v_c], np.asarray(k2_p)[v_c])


def test_dorder_negative_diagonal_no_overflow():
    """In (d, r) order negative-diagonal lanes sort to the FRONT and
    inactive lanes to the end; the row-gather verify must clamp them
    exactly like the element-gather path and reject every such lane."""
    import jax.numpy as jnp
    from muscato_tpu.ops import packed as pops

    rng = np.random.default_rng(9)
    max_rl = 64
    width = 8
    S = 4000
    gene_start = np.array([0, 1500, S], np.int32)
    tcat = rng.integers(0, 4, S).astype(np.uint8)
    codes = rng.integers(0, 4, (32, max_rl)).astype(np.uint8)
    lengths = np.full(32, max_rl, np.int32)
    budget = jnp.asarray(vops.mismatch_budget_table(0.9, max_rl))
    rpacked = pops.pack_rows(jnp.asarray(codes))
    tpacked = pops.pack_stream(tcat)
    trows = pops.build_trows(tpacked, int(rpacked.shape[1]), S)
    gb_np, steps = pops.build_gene_block(gene_start, S)
    q1s = jnp.asarray(np.array([0, 10], np.int32))

    n = 1024
    # (d, r)-sorted unique stream with negative diagonals at the front
    # and inactive lanes at the end.
    d = np.sort(rng.integers(0, S - max_rl, n)).astype(np.int32)
    d[:5] = [-7, -3, -3, -1, 0]
    r = rng.integers(0, 32, n).astype(np.int32)
    r[-37:] = -1

    base = pops.verify_diagonals_packed(
        jnp.asarray(r), jnp.asarray(d), rpacked, jnp.asarray(lengths),
        tpacked, jnp.asarray(gene_start), budget, q1s, width, max_rl, S,
    )
    out = pops.verify_diagonals_packed(
        jnp.asarray(r), jnp.asarray(d), rpacked, jnp.asarray(lengths),
        tpacked, jnp.asarray(gene_start), budget, q1s, width, max_rl, S,
        trows=trows, gblock=jnp.asarray(gb_np), gsteps=steps,
    )
    dead = (r < 0) | (d < 0)
    assert not np.asarray(out[3])[dead].any(), "dead lanes must not pass"
    # okbits must match on every lane; nx/g/s are unspecified on inactive
    # lanes (r < 0) — downstream fetches them only for okbits-retained
    # lanes — so compare them on active lanes only.
    np.testing.assert_array_equal(np.asarray(base[3]), np.asarray(out[3]))
    act = (r >= 0) & (d >= 0)
    for a, b in zip(base[:3], out[:3]):
        np.testing.assert_array_equal(np.asarray(a)[act], np.asarray(b)[act])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rank_core_packed_equals_unpacked(seed):
    """_rank_core_packed (sorts on packed 64-bit words) must retain
    bit-identical rows to the unpacked oracle for both match modes,
    including duplicate (r, g, s) rows, group collisions, negative group
    hash words, dead lanes, and fields straddling the 32-bit seam."""
    from muscato_tpu.ops import fused

    rng = np.random.default_rng(100 + seed)
    n = 2048
    bits = [(22, 17, 21, 4), (20, 20, 20, 4), (10, 10, 10, 4)][seed % 3]
    rb, gb, sb, xb = bits
    # Small value ranges force duplicate (r, g, s) triples; nx is a hash
    # of (r, g, s) — the engine invariant (one verify per read-diagonal).
    r = rng.integers(0, min(1 << rb, 37), n).astype(np.int32)
    g = rng.integers(0, min(1 << gb, 11), n).astype(np.int32)
    s = rng.integers(0, min(1 << sb, 23), n).astype(np.int32)
    r64, g64, s64 = (v.astype(np.int64) for v in (r, g, s))
    nx = ((r64 * 2654435761 + g64 * 40503 + s64 * 2246822519) % (1 << xb)).astype(
        np.int32
    )
    # Group hash words: full int32 range incl. negatives, few buckets so
    # groups actually collide across windows.
    grp = rng.choice(
        np.array([-2**31, -7, 0, 5, 2**31 - 1], dtype=np.int32), n
    )
    grp2 = rng.choice(np.array([-1, 0, 9], dtype=np.int32), n)
    win = rng.integers(0, 3, n).astype(np.int32)
    live = rng.random(n) < 0.85
    buf = jnp.asarray(np.stack([r, g, s, nx, grp, grp2, win], axis=1))
    live_j = jnp.asarray(live)

    for mode in ("best", "first"):
        for mm, mmtol in ((1, 0), (2, 1), (3, 2)):
            exp_rows, exp_n = fused._rank_core(
                buf, live_j, jnp.int32(mm), jnp.int32(mmtol),
                match_mode=mode, full_cols=False, pack_bits=None,
            )
            got_rows, got_n = fused._rank_core(
                buf, live_j, jnp.int32(mm), jnp.int32(mmtol),
                match_mode=mode, full_cols=False, pack_bits=bits,
            )
            assert int(got_n) == int(exp_n) > 0
            got = pipeline._unpack_rows64(
                np.asarray(got_rows)[: int(got_n)], bits
            )
            exp = np.asarray(exp_rows)[: int(exp_n)]
            assert np.array_equal(got, exp), (mode, mm, mmtol)


@pytest.mark.parametrize("dorder", [False, True])
def test_expand_pairs_packed_minor_key_equals_payload_sort(dorder):
    """With smax given, the pair sort packs the window index into the
    minor key's low bits and drops the qid payload operand; the unique
    (r, d) set, lane->unique mapping, and recomputed qid multiset must
    match the payload-carrying sort exactly."""
    from muscato_tpu.ops import fused

    rng = np.random.default_rng(7 + int(dorder))
    nreads, nwin, S, max_rl = 50, 3, 5000, 40
    q1s = jnp.asarray(np.array([0, 7, 19], np.int32))
    m = nwin * nreads
    counts = rng.integers(0, 6, m).astype(np.int32)
    spos = rng.integers(0, S, 4096).astype(np.int32)
    lo = rng.integers(0, 4096 - 8, m).astype(np.int32)
    qid = np.arange(m, dtype=np.int32)
    dead = rng.random(m) < 0.3
    qid[dead] = -1
    counts[dead] = 0
    pair_cap = 1 << int(np.ceil(np.log2(max(int(counts.sum()), 2))))
    args = (jnp.asarray(counts), jnp.asarray(lo), jnp.asarray(qid), q1s,
            jnp.asarray(spos))
    kw = dict(nreads=nreads, pair_cap=pair_cap, dorder=dorder,
              max_read_length=max_rl)
    base = fused._expand_pairs_impl(*args, **kw, smax=None)
    got = fused._expand_pairs_impl(*args, **kw, smax=S)
    for name, a, b in (("nuniq", base[4], got[4]), ("total", base[5], got[5])):
        assert int(a) == int(b), name
    nu = int(base[4])
    np.testing.assert_array_equal(np.asarray(base[2])[:nu], np.asarray(got[2])[:nu])
    np.testing.assert_array_equal(np.asarray(base[3])[:nu], np.asarray(got[3])[:nu])
    # lane -> (qid, unique id) mapping as a multiset (in-run lane order is
    # unspecified: the packed sort orders by k within (r, d) runs).
    def pairs(out):
        q, u = np.asarray(out[0]), np.asarray(out[1])
        act = q >= 0
        return sorted(zip(q[act].tolist(), u[act].tolist()))
    assert pairs(base) == pairs(got)
    assert int(base[5]) > 0


@pytest.mark.parametrize("cap_binds", [False, True])
def test_dorder_equals_rorder(cap_binds, monkeypatch):
    """MUSCATO_DORDER (diagonal-major pair sort) must produce the exact
    (r, d)-order MatchResult, with the MaxMatches cap slack and binding."""
    from muscato_tpu.bench import gendat
    from muscato_tpu.ops import fused

    rs, ts = gendat.generate_arrays_realistic(18_000, 60, 250, 400, 3)
    cfg = Config(
        Windows=[0, 10, 25], WindowWidth=10, PMatch=0.9, MinDinuc=2,
        MaxReadLength=120, MMTol=1,
        MaxMatches=3 if cap_binds else 10**6, MatchMode="best",
    )
    monkeypatch.setattr(fused, "_DORDER", [False])
    mr_a = pipeline.run_matching(cfg, rs, ts)
    monkeypatch.setattr(fused, "_DORDER", [True])
    mr_b = pipeline.run_matching(cfg, rs, ts)
    for a, b in zip(
        (mr_a.read_row, mr_a.gene, mr_a.start, mr_a.nmiss),
        (mr_b.read_row, mr_b.gene, mr_b.start, mr_b.nmiss),
    ):
        np.testing.assert_array_equal(a, b)
    assert len(mr_a.read_row) > 1000
