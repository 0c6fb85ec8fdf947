"""chip_smoke.py's host-side re-check of results.txt, and the GPU-only
entry points refusing a machine without a GPU."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

GENES = {b"gene_0": b"ACGTACGGTCATTGACCAGTTACGATCAGGCATTACG",
         b"gene_1": b"TTGACCGTAGCATCGATTACGGACTTAGCCATGACAT"}
WINDOWS = [0, 8]
WIDTH = 6
PMATCH = 0.8


def _row(read: bytes, gene: bytes, pos: int, nmiss: int) -> bytes:
    tsub = GENES[gene][pos:pos + len(read)]
    return b"\t".join([read, tsub, b"%d" % pos, b"%d" % nmiss, gene,
                       b"%d" % len(GENES[gene]), b"1", b"r"]) + b"\n"


def _mutate(seq: bytes, at: int) -> bytes:
    sub = b"A" if seq[at:at + 1] != b"A" else b"C"
    return seq[:at] + sub + seq[at + 1:]


def _write(tmp_path, rows) -> str:
    path = str(tmp_path / "results.txt")
    with open(path, "wb") as f:
        f.write(b"".join(rows))
    return path


def _true_rows():
    exact = GENES[b"gene_0"][3:23]
    one_off = _mutate(GENES[b"gene_1"][10:30], 17)  # outside both windows
    return [_row(exact, b"gene_0", 3, 0), _row(one_off, b"gene_1", 10, 1)]


def test_check_results_accepts_true_rows(tmp_path):
    path = _write(tmp_path, _true_rows())
    assert chip_smoke.check_results(path, GENES, WINDOWS, WIDTH, PMATCH) == 2


def test_check_results_rejects_wrong_nmiss(tmp_path):
    rows = _true_rows()
    read = GENES[b"gene_1"][10:30]
    rows[1] = _row(_mutate(read, 17), b"gene_1", 10, 2)
    path = _write(tmp_path, rows)
    with pytest.raises(chip_smoke.SmokeError, match="Hamming"):
        chip_smoke.check_results(path, GENES, WINDOWS, WIDTH, PMATCH)


def test_check_results_rejects_mismatched_window(tmp_path):
    # One substitution inside each window: nmiss is right and within the
    # budget, but no window seeds the row.
    read = _mutate(_mutate(GENES[b"gene_0"][3:23], 2), 10)
    path = _write(tmp_path, _true_rows() + [_row(read, b"gene_0", 3, 2)])
    with pytest.raises(chip_smoke.SmokeError, match="no window"):
        chip_smoke.check_results(path, GENES, WINDOWS, WIDTH, PMATCH)


def _cpu_only_env():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.mark.parametrize(
    "script",
    ["chip_smoke.py", "bench.py",
     "-m muscato_tpu.bench.stage_profile --Out sp.json --Trace sp_trace"],
)
def test_gpu_entry_points_refuse_cpu(script):
    r = subprocess.run(
        [sys.executable, *script.split()], cwd=REPO, env=_cpu_only_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "reads_per_sec" not in r.stdout
    assert "GPU" in r.stderr


def test_driver_runs_on_cpu_only_when_asked():
    code = ("import jax; from muscato_tpu.engine.driver import "
            "require_device; require_device(); "
            "print(jax.devices()[0].platform)")
    asked = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                           env=_cpu_only_env(), capture_output=True,
                           text=True, timeout=300)
    assert asked.returncode == 0 and asked.stdout.strip() == "cpu"
    env = {k: v for k, v in _cpu_only_env().items() if k != "JAX_PLATFORMS"}
    plain = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=300)
    if plain.returncode == 0:
        # Only a machine with an accelerator may run without being asked.
        assert plain.stdout.strip() != "cpu"
    else:
        assert "JAX_PLATFORMS=cpu" in plain.stderr
