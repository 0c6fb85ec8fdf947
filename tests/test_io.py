"""IO-layer tests: snappy codec, sequence codec, prep_targets golden parity.

Golden inputs/outputs come from the reference repo's test data
(tests/data/prep_targets/00-07, manifest tests/tests.toml), at
conftest.REFERENCE_DATA; those tests skip where it is absent.
"""

import gzip
import os
import random
import shutil

import numpy as np
import pytest

from muscato_tpu.io import reads, seqcodec, sz, targets


@pytest.fixture
def ref(reference_tests):
    return os.path.join(reference_tests, "data", "prep_targets")


# ------------------------------------------------------------------ snappy ---


def test_crc32c_known_vectors():
    # Standard CRC-32C test vectors.
    assert sz.crc32c(b"") == 0
    assert sz.crc32c(b"123456789") == 0xE3069283
    assert sz.crc32c(b"\x00" * 32) == 0x8A9136AA


def test_snappy_roundtrip_random():
    rng = random.Random(0)
    for n in [0, 1, 3, 100, 65536, 65537, 200000]:
        # Mix of compressible and incompressible content.
        data = bytes(rng.randrange(4) for _ in range(n // 2)) + bytes(
            rng.randrange(256) for _ in range(n - n // 2)
        )
        assert sz.decompress(sz.compress(data)) == data
        assert sz.decompress(sz.compress(data, level=0)) == data


def test_snappy_block_roundtrip():
    for data in [b"", b"a", b"abcabcabcabcabcabcabc" * 100, bytes(range(256)) * 10]:
        assert sz.block_decompress(sz.block_compress(data)) == data


def test_snappy_reads_reference_file(ref):
    # Real golang/snappy-compressed file from the reference test data.
    raw = sz.read_bytes(os.path.join(ref, "06", "genes.txt.sz"))
    assert raw.split(b"\n")[0].startswith(b"gene1\t")


# ---------------------------------------------------------------- seqcodec ---


def test_codec_roundtrip_and_subx():
    assert seqcodec.subx_bytes(b"ACGTnN z") == b"ACGTXXXX"
    assert seqcodec.decode(seqcodec.encode(b"ACGTX")) == b"ACGTX"


def test_revcomp():
    assert seqcodec.revcomp_bytes(b"AACGTX") == b"XACGTT"
    assert seqcodec.revcomp_bytes(b"ATACGATCTACGATCA") == b"TGATCGTAGATCGTAT"


def test_dinuc_count():
    # "AAAA" -> only dinuc AA -> 1.  "ACGT" -> AC,CG,GT -> 3.
    assert seqcodec.dinucleotide_count(seqcodec.encode(b"AAAA")) == 1
    assert seqcodec.dinucleotide_count(seqcodec.encode(b"ACGT")) == 3
    assert seqcodec.dinucleotide_count(seqcodec.encode(b"A")) == 0


# ------------------------------------------------------------ prep_targets ---

# (case, input file, rev) mirroring tests/tests.toml:1-68
PREP_CASES = [
    ("00", "genes.fasta", False),
    ("01", "genes.fasta", True),
    ("02", "genes.txt", False),
    ("03", "genes.txt", True),
    ("04", "genes.txt.gz", False),
    ("05", "genes.txt.gz", True),
    ("06", "genes.txt.sz", True),
    ("07", "genes.txt.sz", True),
]


@pytest.mark.parametrize("case,fname,rev", PREP_CASES)
def test_prep_targets_golden(case, fname, rev, tmp_path, ref):
    src = os.path.join(ref, case, fname)
    dst = tmp_path / fname
    shutil.copy(src, dst)

    seq_path, ids_path = targets.prep_targets(str(dst), rev=rev)

    with open(os.path.join(ref, case, "expected_sequences.txt"), "rb") as f:
        exp_seq = f.read()
    with open(os.path.join(ref, case, "expected_ids.txt"), "rb") as f:
        exp_ids = f.read()

    assert sz.read_bytes(seq_path) == exp_seq
    assert sz.read_bytes(ids_path) == exp_ids


def test_prepared_names():
    assert targets.prepared_names("a/genes.fasta") == (
        "a/musc_genes.fasta.sz",
        "a/musc_ids_genes.fasta.sz",
    )
    assert targets.prepared_names("genes.txt.gz") == (
        "musc_genes.txt.sz",
        "musc_ids_genes.txt.sz",
    )
    assert targets.prepared_names("genes.txt.sz") == (
        "musc_genes.txt.sz",
        "musc_ids_genes.txt.sz",
    )


def test_load_targets(tmp_path, ref):
    src = os.path.join(ref, "02", "genes.txt")
    dst = tmp_path / "genes.txt"
    shutil.copy(src, dst)
    seq_path, ids_path = targets.prep_targets(str(dst))
    ts = targets.load_targets(seq_path, ids_path)
    assert ts.num_genes == 3
    assert ts.names == [b"gene1", b"gene2", b"gene3"]
    assert list(ts.lengths) == [16, 12, 8]
    assert seqcodec.decode(ts.tcat[: ts.gene_start[1]]) == b"ATACGATCTACGATCA"


# ------------------------------------------------------------------- reads ---


def _fastq(records):
    out = b""
    for name, seq in records:
        out += name + b"\n" + seq + b"\n+\n" + b"!" * len(seq) + b"\n"
    return out


def test_build_readset_dedup_and_order(tmp_path):
    fq = _fastq(
        [
            (b">r2", b"GGGG"),
            (b">r1", b"ACGT"),
            (b">r3", b"ACGT"),
            (b">r4", b"AC"),  # shorter than MinReadLength
            (b">r5", b"ACGTACGTACGT"),  # truncated at 8
        ]
    )
    p = tmp_path / "reads.fastq"
    p.write_bytes(fq)
    rs = reads.build_readset(str(p), min_read_length=3, max_read_length=8)
    assert rs.seqs == [b"ACGT", b"ACGTACGT", b"GGGG"]
    assert list(rs.counts) == [2, 1, 1]
    assert rs.names == [b">r1;>r3", b">r5", b">r2"]
    assert rs.num_total == 4
    assert list(rs.lengths) == [4, 8, 4]
    np.testing.assert_array_equal(
        rs.codes[0], np.array([0, 1, 2, 3, 0, 0, 0, 0], dtype=np.uint8)
    )


def test_name_truncation(tmp_path):
    longname = b"@" + b"n" * 1200
    fq = _fastq([(longname, b"ACGT")])
    p = tmp_path / "reads.fastq"
    p.write_bytes(fq)
    rs = reads.build_readset(str(p), 0, 10)
    # prep_reads truncation: name[:995] + "..."  (998 bytes)
    assert rs.names[0] == longname[:995] + b"..."
    assert len(rs.names[0]) == 998


def test_joined_name_truncation(tmp_path):
    recs = [(b"@name_%04d" % i, b"ACGT") for i in range(200)]
    p = tmp_path / "reads.fastq"
    p.write_bytes(_fastq(recs))
    rs = reads.build_readset(str(p), 0, 10)
    assert len(rs.seqs) == 1
    assert rs.counts[0] == 200
    joined = b";".join(sorted(n for n, _ in recs))
    assert rs.names[0] == joined[:996] + b"..."


def test_native_codec_cross_validation():
    """Native C++ codec and pure-Python codec must interoperate."""
    from muscato_tpu.io import native
    from muscato_tpu.io.sz import _compress_py, _decompress_py

    if native.get_lib() is None:
        pytest.skip("native library not built")
    rng = random.Random(7)
    for n in [0, 3, 1000, 65537, 150000]:
        data = bytes(rng.randrange(7) for _ in range(n // 2)) + bytes(
            rng.randrange(256) for _ in range(n - n // 2)
        )
        c_nat = native.frame_compress(data)
        assert _decompress_py(c_nat) == data
        assert native.frame_decompress(_compress_py(data)) == data
        assert native.frame_decompress(c_nat) == data
    assert native.crc32c(b"123456789") == 0xE3069283


def test_blob_primitives_numpy_fallback(monkeypatch):
    """The numpy fallbacks must match the native implementations."""
    import numpy as np
    from muscato_tpu.io import blob, native

    rng = np.random.default_rng(0)
    src = rng.integers(0, 255, 5000).astype(np.uint8)
    starts = np.sort(rng.choice(4000, 50, replace=False)).astype(np.int64)
    lens = rng.integers(0, 20, 50).astype(np.int64)
    table = rng.integers(0, 255, 256).astype(np.uint8)

    def run_all():
        out_starts = np.cumsum(lens) - lens
        dst = np.zeros(int(lens.sum()) + 10, np.uint8)
        blob.ranged_copy(dst, out_starts, src, starts, lens)
        enc = np.zeros((50, 24), np.uint8)
        blob.encode_rows_matrix(src, starts, lens.astype(np.int32), 24, table, 7, enc)
        dec = np.zeros(int(lens.sum()) + 10, np.uint8)
        blob.decode_rows_blob(dec, out_starts, src, 1, starts, lens, table)
        return dst.copy(), enc.copy(), dec.copy()

    native_res = run_all()
    monkeypatch.setattr(native, "get_lib", lambda: None)
    np_res = run_all()
    for a, b in zip(native_res, np_res):
        np.testing.assert_array_equal(a, b)


def test_readset_build_numpy_fallback(monkeypatch, tmp_path):
    """build_readset must give identical results without the native lib."""
    import numpy as np
    from muscato_tpu.io import native, reads as rio

    fq = tmp_path / "r.fastq"
    fq.write_bytes(
        b"@a\nACGTNN\n+\n!!!!!!\n"
        b"@b\nACGTNN\n+\n!!!!!!\n"
        b"@c\nTTT\n+\n!!!\n"
        b"@d\nACGTACGTACGT\n+\n!!!!!!!!!!!!\n"
    )
    rs1 = rio.build_readset(str(fq), 4, 8)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    rs2 = rio.build_readset(str(fq), 4, 8)
    np.testing.assert_array_equal(rs1.codes, rs2.codes)
    np.testing.assert_array_equal(rs1.counts, rs2.counts)
    assert rs1.names == rs2.names
    assert rs1.seqs == rs2.seqs
    assert rs1.num_total == rs2.num_total == 3  # 'c' fails MinReadLength
    assert rs1.counts.sum() == 3
    # C-locale order: 'ACGTACGT' (read d, truncated at 8) < 'ACGTXX' (a+b)
    assert rs1.seqs == [b"ACGTACGT", b"ACGTXX"]
    assert rs1.names == [b"@d", b"@a;@b"]
    assert rs1.counts.tolist() == [1, 2]


def test_generate_big_matches_generate_layout(tmp_path):
    """generate_big streams the fastq in chunks: names must stay unique
    and sequential across chunk boundaries and every record well-formed;
    the gene file must parse like generate()'s."""
    from muscato_tpu.bench import gendat
    from muscato_tpu.io import sz

    d = tmp_path / "big"
    d.mkdir()
    reads_path, genes_path = gendat.generate_big(
        100, 20, 30, 120, out_dir=str(d), seed=5, chunk=32, hit_frac=0.5,
        sub_rate=0.05,
    )
    lines = open(reads_path, "rb").read().split(b"\n")
    assert lines[-1] == b""
    recs = [lines[i : i + 4] for i in range(0, len(lines) - 1, 4)]
    assert len(recs) == 100
    for i, (nm, seq, plus, qual) in enumerate(recs):
        assert nm == b"read_%d" % i  # unique, sequential across chunks
        assert len(seq) == 20 and plus == b"+" and qual == b"!" * 20
        assert set(seq) <= set(b"ATGC")
    gtxt = sz.read_bytes(genes_path).split(b"\n")
    assert len(gtxt) == 31 and gtxt[-1] == b""
    for j, row in enumerate(gtxt[:-1]):
        nm, seq = row.split(b"\t")
        assert nm == b"gene_%d" % j and len(seq) == 120

    # hit_frac reads must verify against the genes (sampled, low sub rate):
    # at least one read of each chunk's hit prefix appears near-verbatim.
    genes = [r.split(b"\t")[1] for r in gtxt[:-1]]
    cat = b"".join(genes)
    hits = sum(1 for _nm, seq, _p, _q in recs if seq in cat)
    assert hits > 10  # 50% sampled at 5% sub rate -> plenty of exact hits


def test_stream_writer_byte_identity(tmp_path):
    """StreamWriter output == write_bytes for every slicing of the input
    (frames re-block to 64KB internally), including empty and sub-frame
    writes, so large emitters can stream in bounded memory."""
    rng = random.Random(11)
    data = bytes(rng.randrange(4) for _ in range(200_000))  # compressible
    data += os.urandom(150_000)                              # incompressible
    ref = tmp_path / "ref.sz"
    sz.write_bytes(str(ref), data)
    for slicing in ([len(data)], [1, 65535, 65536, 131072],
                    [100] * 5, [0, 3, 70000]):
        p = tmp_path / "s.sz"
        with sz.StreamWriter(str(p)) as w:
            pos = 0
            for k in slicing:
                w.write(data[pos:pos + k])
                pos += k
            w.write(data[pos:])
        assert p.read_bytes() == ref.read_bytes()
        assert sz.read_bytes(str(p)) == data
    # empty stream matches write_bytes(b"")
    e1, e2 = tmp_path / "e1.sz", tmp_path / "e2.sz"
    sz.write_bytes(str(e1), b"")
    with sz.StreamWriter(str(e2)) as w:
        pass
    assert e1.read_bytes() == e2.read_bytes()
    # non-.sz passthrough
    t = tmp_path / "plain.txt"
    with sz.StreamWriter(str(t)) as w:
        w.write(b"ab")
        w.write(b"cd")
    assert t.read_bytes() == b"abcd"


def test_write_reads_sorted_sliced_identity(tmp_path):
    """The sliced reads_sorted writer is byte-identical to the one-shot
    emission at every slice size (1-row slices cross every boundary)."""
    recs = [(b">r%d" % i, bytes(random.Random(i).choices(b"ACGT", k=20)))
            for i in range(97)]
    recs += recs[:13]  # duplicates exercise counts/joined names
    p = tmp_path / "reads.fastq"
    p.write_bytes(_fastq(recs))
    rs = reads.build_readset(str(p), min_read_length=3, max_read_length=32)
    outs = []
    for slc in (10**9, 7, 1):
        q = tmp_path / f"rs_{slc}.txt.sz"
        reads.write_reads_sorted(rs, str(q), rows_per_slice=slc)
        outs.append(q.read_bytes())
    assert outs[0] == outs[1] == outs[2]
    text = sz.decompress(outs[0])
    assert text.count(b"\n") == rs.num_unique
