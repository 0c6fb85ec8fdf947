"""End-to-end golden parity tests against the reference's muscato cases.

Each case from the reference's tests/data/muscato/00-04 is run through the
full driver (prep targets -> match -> report) in a temp dir, and result.txt
plus the nonmatch fastq are compared byte-for-byte with the goldens
(result_e.txt, result.nonmatch_e.txt), exactly as tests/tests.toml does.

The reference configs point at 'genes.txt.sz'/'genes_ids.txt.sz' while
muscato_prep_targets emits 'musc_genes.txt.sz'/'musc_ids_genes.txt.sz' — a
known staleness quirk (SURVEY.md section 4); like the reference harness's
out-of-band setup, we prepare and rename.
"""

import json
import os
import shutil

import pytest

from muscato_tpu import config as config_mod
from muscato_tpu.engine import driver
from muscato_tpu.io import targets


@pytest.fixture
def ref(reference_tests):
    return os.path.join(reference_tests, "data", "muscato")


# case -> -rev for prep_targets (case 04 uses a reverse-complemented DB,
# tests/tests.toml "muscato 4 prep")
CASES = {"00": False, "01": False, "02": False, "03": False, "04": True}


def run_case(case: str, tmp_path, ref, mutate_cfg=None):
    src = os.path.join(ref, case)
    work = tmp_path / case
    work.mkdir(parents=True)
    for f in ("reads.fastq", "genes.txt", "config.json"):
        shutil.copy(os.path.join(src, f), work / f)

    seq_path, ids_path = targets.prep_targets(str(work / "genes.txt"), rev=CASES[case])
    os.rename(seq_path, work / "genes.txt.sz")
    os.rename(ids_path, work / "genes_ids.txt.sz")

    with open(work / "config.json") as f:
        raw = json.load(f)
    raw["ReadFileName"] = str(work / "reads.fastq")
    raw["GeneFileName"] = str(work / "genes.txt.sz")
    raw["GeneIdFileName"] = str(work / "genes_ids.txt.sz")
    raw["ResultsFileName"] = str(work / "result.txt")
    raw["TempDir"] = str(work / "tmp")
    raw["LogDir"] = str(work / "logs")
    if mutate_cfg:
        raw = mutate_cfg(raw)
    cfg_path = work / "config_run.json"
    with open(cfg_path, "wt") as f:
        json.dump(raw, f)

    cfg = config_mod.Config.from_json_file(str(cfg_path))
    config_mod.apply_defaults(cfg)
    driver.run(cfg)
    return work


@pytest.mark.parametrize("case", sorted(CASES))
def test_muscato_golden(case, tmp_path, ref):
    work = run_case(case, tmp_path, ref)

    with open(work / "result.txt", "rb") as f:
        got = f.read()
    with open(os.path.join(ref, case, "result_e.txt"), "rb") as f:
        exp = f.read()
    assert got == exp, f"result.txt mismatch for case {case}"

    with open(work / "result.nonmatch.txt.fastq", "rb") as f:
        got_nm = f.read()
    with open(os.path.join(ref, case, "result.nonmatch_e.txt"), "rb") as f:
        exp_nm = f.read()
    assert got_nm == exp_nm, f"nonmatch mismatch for case {case}"


def test_stats_outputs(tmp_path, ref):
    work = run_case("03", tmp_path, ref)
    with open(work / "result_readstats.txt", "rb") as f:
        rstats = f.read()
    # 3 reads all matching; read ids are single names here.
    assert rstats == (
        b">read3\tgene6;\n"
        b">read2\tgene6;gene7;\n"
        b">read1\tgene1;gene3;gene7;gene8;\n"
    )
    with open(work / "result_genestats.txt", "rb") as f:
        gstats = f.read()
    assert gstats == (
        b"gene1\t1\t\ngene3\t1\t\ngene6\t2\t\ngene7\t2\t\ngene8\t2\t\n"
    )


def test_logs_and_temp(tmp_path, ref):
    work = run_case("00", tmp_path, ref)
    logdirs = os.listdir(work / "logs")
    assert len(logdirs) == 1
    logdir = work / "logs" / logdirs[0]
    assert (logdir / "config.json").exists()
    assert (logdir / "muscato.log").exists()
    info = json.load(open(logdir / "seqinfo.json"))
    assert info == {"NumUnique": 6, "NumTotal": 6}
    # NoCleanTemp not set -> temp dir removed
    tmpdirs = os.listdir(work / "tmp")
    assert tmpdirs == []


def test_read_batch_streaming(tmp_path, ref):
    """Multi-batch streaming must match the single-batch result."""
    def mutate(raw):
        raw["ReadBatch"] = 2  # 6 unique reads -> 3 batches of 2
        return raw

    work = run_case("03", tmp_path, ref, mutate_cfg=mutate)
    with open(work / "result.txt", "rb") as f:
        got = f.read()
    with open(os.path.join(ref, "03", "result_e.txt"), "rb") as f:
        assert got == f.read()


def test_resume_from_artifacts(tmp_path, ref):
    """A run resumed from a previous run's matches.npz reproduces results."""
    work = run_case("02", tmp_path, ref)
    tmpdirs = os.listdir(work / "tmp")
    assert not tmpdirs  # cleaned

    def keep(raw):
        raw["NoCleanTemp"] = True
        return raw

    work2 = run_case("02", tmp_path / "second", ref, mutate_cfg=keep)
    prev = work2 / "tmp" / os.listdir(work2 / "tmp")[0]
    assert (prev / "matches.npz").exists()

    def resume(raw):
        raw["ResumeDir"] = str(prev)
        return raw

    work3 = run_case("02", tmp_path / "third", ref, mutate_cfg=resume)
    with open(work3 / "result.txt", "rb") as f:
        got = f.read()
    with open(os.path.join(ref, "02", "result_e.txt"), "rb") as f:
        assert got == f.read()


def test_single_device_mode_golden(tmp_path, ref):
    """Mesh='off' forces the single-device engine even when several devices
    are visible; outputs stay byte-identical."""
    def mutate(raw):
        raw["Mesh"] = "off"
        return raw

    work = run_case("03", tmp_path, ref, mutate_cfg=mutate)
    with open(work / "result.txt", "rb") as f:
        got = f.read()
    with open(os.path.join(ref, "03", "result_e.txt"), "rb") as f:
        assert got == f.read()


def test_explicit_mesh_golden(tmp_path, ref):
    """An explicit DPxMP mesh through the driver produces golden output."""
    def mutate(raw):
        raw["Mesh"] = "2x4"
        return raw

    work = run_case("03", tmp_path, ref, mutate_cfg=mutate)
    with open(work / "result.txt", "rb") as f:
        got = f.read()
    with open(os.path.join(ref, "03", "result_e.txt"), "rb") as f:
        assert got == f.read()
    with open(work / "result.nonmatch.txt.fastq", "rb") as f:
        got_nm = f.read()
    with open(os.path.join(ref, "03", "result.nonmatch_e.txt"), "rb") as f:
        assert got_nm == f.read()


def test_index_file_roundtrip(tmp_path, ref):
    """IndexFile persists the built index; a second run loads it (skipping
    the build sort) and reproduces results byte-for-byte."""
    idx_path = str(tmp_path / "genes.index.npz")

    def mutate(raw):
        raw["Mesh"] = "off"  # index cache applies to the single-device path
        raw["IndexFile"] = idx_path
        return raw

    work = run_case("03", tmp_path, ref, mutate_cfg=mutate)
    assert os.path.exists(idx_path)
    work2 = run_case("03", tmp_path / "again", ref, mutate_cfg=mutate)
    with open(work2 / "result.txt", "rb") as f:
        got = f.read()
    with open(os.path.join(ref, "03", "result_e.txt"), "rb") as f:
        assert got == f.read()
