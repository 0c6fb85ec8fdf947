"""Sharded-path tests: N-device output must equal the single-device output.

Runs on 8 virtual CPU devices (conftest sets
--xla_force_host_platform_device_count=8).
"""

import numpy as np
import pytest

import jax

from muscato_tpu.config import Config
from muscato_tpu.engine import pipeline
from muscato_tpu.io import seqcodec
from muscato_tpu.io.reads import ReadSet
from muscato_tpu.io.targets import TargetSet
from muscato_tpu.parallel import mesh as pmesh


def _mk_sets(rng, n_reads, n_genes, width, max_rl):
    genes = [
        "".join(rng.choice(list("ACGT"), size=rng.integers(width, 80)))
        for _ in range(n_genes)
    ]
    reads = []
    for _ in range(n_reads):
        g = genes[rng.integers(len(genes))]
        if len(g) > width + 2 and rng.random() < 0.8:
            a = int(rng.integers(0, len(g) - width))
            b = int(rng.integers(a + width, min(len(g), a + max_rl) + 1))
            frag = list(g[a:b])
            for _ in range(int(rng.integers(0, 3))):
                frag[int(rng.integers(len(frag)))] = "ACGT"[int(rng.integers(4))]
            reads.append("".join(frag))
        else:
            reads.append("".join(rng.choice(list("ACGT"), size=width + 5)))

    codes, lengths = seqcodec.encode_rows([r.encode() for r in reads], max_rl)
    rs = ReadSet(
        codes=codes, lengths=lengths,
        counts=np.ones(len(reads), np.int64),
        names=[b"r%d" % i for i in range(len(reads))],
        seqs=[r.encode() for r in reads], num_total=len(reads),
    )
    gene_start = np.zeros(len(genes) + 1, np.int64)
    for i, g in enumerate(genes):
        gene_start[i + 1] = gene_start[i] + len(g)
    ts = TargetSet(
        tcat=np.concatenate([seqcodec.encode(g.encode()) for g in genes]),
        gene_start=gene_start,
        names=[b"g%d" % i for i in range(len(genes))],
        lengths=np.diff(gene_start),
    )
    return rs, ts


@pytest.mark.parametrize(
    "dp,mp,n_reads",
    [(1, 8, 40), (2, 4, 40), (8, 1, 40), (4, 2, 40),
     # ragged dp splits: read counts not divisible by dp exercise the
     # pad/offset bookkeeping (41 % 8 = 1, 37 % 4 = 1, 43 % 2 = 1)
     (8, 1, 41), (4, 2, 37), (2, 4, 43)],
)
def test_sharded_equals_single(dp, mp, n_reads):
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    rng = np.random.default_rng(dp * 31 + mp + n_reads)
    width = 6
    max_rl = 40
    cfg = Config(
        Windows=[0, 4], WindowWidth=width, PMatch=0.9, MinDinuc=1,
        MaxReadLength=max_rl, MMTol=1, MaxMatches=10**6, MatchMode="best",
    )
    rs, ts = _mk_sets(rng, n_reads=n_reads, n_genes=12, width=width, max_rl=max_rl)

    single = pipeline.run_matching(cfg, rs, ts)
    expected = set(
        zip(single.read_row.tolist(), single.gene.tolist(),
            single.start.tolist(), single.nmiss.tolist())
    )

    mesh = pmesh.make_mesh(dp, mp)
    sidx = pmesh.shard_targets(ts, width, mp)
    mr = pmesh.run_matching_sharded(cfg, rs, sidx, mesh)
    got = set(
        zip(mr.read_row.tolist(), mr.gene.tolist(),
            mr.start.tolist(), mr.nmiss.tolist())
    )
    assert got == expected


@pytest.mark.parametrize("nodedup", [False, True])
@pytest.mark.parametrize("dorder", [False, True])
def test_sharded_with_kernels_equals_single(dorder, nodedup, monkeypatch):
    """Both pair orders and both expand+verify engines (diagonal dedup and
    streaming) inside shard_map must produce the single-device result —
    the mesh path runs the same engine as the single-device loop."""
    from muscato_tpu.ops import fused

    rng = np.random.default_rng(29)
    width, max_rl = 6, 40
    cfg = Config(
        Windows=[0, 4], WindowWidth=width, PMatch=0.9, MinDinuc=1,
        MaxReadLength=max_rl, MMTol=1, MaxMatches=10**6, MatchMode="best",
    )
    rs, ts = _mk_sets(rng, n_reads=48, n_genes=12, width=width, max_rl=max_rl)
    monkeypatch.setattr(fused, "_DORDER", [False])
    single = pipeline.run_matching(cfg, rs, ts)
    expected = set(
        zip(single.read_row.tolist(), single.gene.tolist(),
            single.start.tolist(), single.nmiss.tolist())
    )
    assert expected
    mesh = pmesh.make_mesh(2, 2)
    sidx = pmesh.shard_targets(ts, width, 2)
    cfg.NoDedup = nodedup
    monkeypatch.setattr(fused, "_DORDER", [dorder])
    mr = pmesh.run_matching_sharded(cfg, rs, sidx, mesh)
    got = set(
        zip(mr.read_row.tolist(), mr.gene.tolist(),
            mr.start.tolist(), mr.nmiss.tolist())
    )
    assert got == expected


def test_sharded_nrun_read_no_phantom_matches():
    """A read made of non-ACGT bases (encoded X) must not match shard
    padding (which is X-filled): pad windows are invalid by construction.
    Round-1 advisor finding: pad windows shared one pad gene id and could
    emit phantom matches with out-of-range gene ids."""
    width = 6
    max_rl = 40
    cfg = Config(
        Windows=[0], WindowWidth=width, PMatch=0.9, MinDinuc=0,
        MaxReadLength=max_rl, MMTol=1, MaxMatches=10**6, MatchMode="best",
    )
    rng = np.random.default_rng(11)
    rs, ts = _mk_sets(rng, n_reads=6, n_genes=5, width=width, max_rl=max_rl)
    # Append an all-N read (codes become X=4): with MinDinuc=0 its windows
    # are seeded and would match an X-padded pad region byte-for-byte.
    nread = b"N" * 20
    codes = np.zeros((rs.codes.shape[0] + 1, rs.codes.shape[1]), rs.codes.dtype)
    codes[:-1] = rs.codes
    codes[-1, :20] = 4
    rs.codes = codes
    rs.lengths = np.concatenate([rs.lengths, [20]]).astype(np.int32)
    rs.counts = np.concatenate([rs.counts, [1]])
    rs.names.append(b"nrun")
    rs.seqs.append(nread)
    rs.num_total += 1

    single = pipeline.run_matching(cfg, rs, ts)
    expected = set(
        zip(single.read_row.tolist(), single.gene.tolist(),
            single.start.tolist(), single.nmiss.tolist())
    )
    mesh = pmesh.make_mesh(2, 4)
    sidx = pmesh.shard_targets(ts, width, 4)
    mr = pmesh.run_matching_sharded(cfg, rs, sidx, mesh)
    got = set(
        zip(mr.read_row.tolist(), mr.gene.tolist(),
            mr.start.tolist(), mr.nmiss.tolist())
    )
    assert got == expected
    assert all(g < ts.num_genes for _, g, _, _ in got)


def test_shard_targets_partition():
    rng = np.random.default_rng(7)
    _, ts = _mk_sets(rng, 1, 10, 5, 20)
    sidx = pmesh.shard_targets(ts, 5, 4)
    # Every gene appears in exactly one shard; bases are contiguous.
    bases = np.asarray(sidx.gene_base)
    assert bases[0] == 0
    assert np.all(np.diff(bases) >= 0)


def test_overflow_detection():
    rng = np.random.default_rng(3)
    cfg = Config(
        Windows=[0], WindowWidth=4, PMatch=1.0, MinDinuc=0,
        MaxReadLength=20, MMTol=0, MaxMatches=10**6, MatchMode="best",
    )
    # Low-entropy data: every window matches everywhere -> pair blowup.
    reads = ["AAAAAAAA"] * 8
    genes = ["A" * 60] * 4
    codes, lengths = seqcodec.encode_rows([r.encode() for r in reads], 20)
    gene_start = np.zeros(5, np.int64)
    for i, g in enumerate(genes):
        gene_start[i + 1] = gene_start[i] + len(g)
    ts = TargetSet(
        tcat=np.concatenate([seqcodec.encode(g.encode()) for g in genes]),
        gene_start=gene_start, names=[b"g%d" % i for i in range(4)],
        lengths=np.diff(gene_start),
    )
    mesh = pmesh.make_mesh(1, 2)
    sidx = pmesh.shard_targets(ts, 4, 2)
    # Overflow is handled IN PLACE: the stage-2 loop regrows the survivor
    # capacity (reusing the probe) and returns the grown cap for the
    # caller's hint — no exception escapes.
    cols, cap = pmesh.sharded_match_arrays(
        cfg, codes, lengths, sidx, mesh, surv_cap=8
    )
    assert cap > 8
    assert len(cols[0]) > 8


def test_sharded_capacity_regrow():
    """run_matching_sharded regrows survivor capacity on overflow and still
    matches the single-chip result (mirrors the single-chip driver loop)."""
    rng = np.random.default_rng(13)
    width = 6
    max_rl = 40
    cfg = Config(
        Windows=[0, 4], WindowWidth=width, PMatch=0.9, MinDinuc=1,
        MaxReadLength=max_rl, MMTol=1, MaxMatches=10**6, MatchMode="best",
    )
    rs, ts = _mk_sets(rng, n_reads=64, n_genes=8, width=width, max_rl=max_rl)
    single = pipeline.run_matching(cfg, rs, ts)
    expected = set(
        zip(single.read_row.tolist(), single.gene.tolist(),
            single.start.tolist(), single.nmiss.tolist())
    )
    mesh = pmesh.make_mesh(2, 2)
    sidx = pmesh.shard_targets(ts, width, 2)
    # Start tiny so at least one regrow is exercised.
    mr = _run_sharded_with_cap(cfg, rs, sidx, mesh, start_cap=8)
    got = set(
        zip(mr.read_row.tolist(), mr.gene.tolist(),
            mr.start.tolist(), mr.nmiss.tolist())
    )
    assert got == expected


def _run_sharded_with_cap(cfg, rs, sidx, mesh, start_cap):
    """sharded_match_arrays with a tiny initial capacity (test hook):
    overflow must regrow in place and return the grown cap."""
    from muscato_tpu.engine import pipeline as pl
    from muscato_tpu.ops import fused

    codes = np.asarray(rs.codes)
    lengths = np.asarray(rs.lengths)
    cols, cap = pmesh.sharded_match_arrays(
        cfg, codes, lengths, sidx, mesh, surv_cap=start_cap
    )
    assert cap > start_cap, "test should exercise at least one regrow"
    rows = np.stack(cols, axis=1)
    r, g, s, nx, grp, grp2, win = (rows[:, i] for i in range(fused.NCOL))
    r, g, s, nx = pl._apply_max_matches(cfg, r, g, s, nx, grp, grp2, win)
    return pl._dedup_and_rank(cfg, r, g, s, nx)
