"""Run the reference's own test manifest (tests/tests.toml) end to end.

Mirrors the reference harness (tests/test.go upstream): each [[Test]]
entry runs as a real command against a copy of the reference data tree, and
each [actual, expected] file pair is compared with transparent .sz
decompression (test.go:94-135).

Like the reference harness, the muscato entries only work with out-of-band
preparation: their configs point at genes.txt.sz / genes_ids.txt.sz while
muscato_prep_targets emits musc_* names (the staleness quirk documented in
SURVEY.md section 4), so prepared outputs are renamed into place — for the
dirs with an explicit prep entry, right after it runs; for dirs without one
(00, 01), in a pre-pass.
"""

import os
import shutil
import tomllib

import pytest

from muscato_tpu import cli
from muscato_tpu.io import sz, targets



def _load_manifest(ref_tests):
    with open(os.path.join(ref_tests, "tests.toml"), "rb") as f:
        return tomllib.load(f)["Test"]


def _rename_prepared(dirpath: str, raw: str) -> None:
    seq, ids = targets.prepared_names(os.path.join(dirpath, raw))
    os.replace(seq, os.path.join(dirpath, "genes.txt.sz"))
    os.replace(ids, os.path.join(dirpath, "genes_ids.txt.sz"))


@pytest.fixture
def tree(tmp_path, reference_tests):
    root = tmp_path / "reftests"
    shutil.copytree(os.path.join(reference_tests, "data"), root / "data")
    # Pre-pass: muscato dirs without a prep entry in the manifest.
    for case in ("00", "01"):
        d = str(root / "data" / "muscato" / case)
        targets.prep_targets(os.path.join(d, "genes.txt"))
        _rename_prepared(d, "genes.txt")
    return root


def test_reference_manifest(tree, reference_tests):
    manifest = _load_manifest(reference_tests)
    assert len(manifest) == 17
    ran = 0
    cwd = os.getcwd()
    try:
        os.chdir(tree)
        for entry in manifest:
            cmd = entry["Command"]
            base = entry.get("Base", "")
            opts = entry.get("Opts", [])
            args = [os.path.join(base, a) for a in entry.get("Args", [])]

            if cmd == "muscato_prep_targets":
                cli.main_prep_targets(opts + args)
                if "muscato/" in base.replace(os.sep, "/"):
                    _rename_prepared(base, entry["Args"][0])
            elif cmd == "muscato":
                cli.main_muscato(opts)
            else:
                raise AssertionError(f"unknown command {cmd}")

            for actual, expected in entry.get("Files", []):
                got = sz.read_bytes(os.path.join(base, actual))
                exp = sz.read_bytes(os.path.join(base, expected))
                assert got == exp, f"{entry['Name']}: {actual} != {expected}"
                ran += 1
    finally:
        os.chdir(cwd)
    assert ran == 28  # every compared file pair in the manifest
