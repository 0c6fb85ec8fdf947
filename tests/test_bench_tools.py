"""The measurement helpers: the device-program recorder (bench.dispatches)
that chip_smoke.py's compile phase reads, and stage_profile's trace
reduction and pair-order schedule."""

import os
import sys

import jax
import pytest
from jax.profiler import ProfileData

from muscato_tpu.bench import gendat, stage_profile
from muscato_tpu.bench.dispatches import Dispatches, record_dispatches
from muscato_tpu.config import Config
from muscato_tpu.engine import pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def recorded():
    rs, ts = gendat.generate_arrays_realistic(3000, 100, 40, 1000, seed=7)
    cfg = Config(Windows=[10, 30, 50, 70], WindowWidth=20, PMatch=0.96,
                 MinDinuc=3, MaxReadLength=200, MMTol=2, MaxMatches=10**6,
                 MatchMode="best")
    with record_dispatches(keep_outputs=True) as rec:
        mr = pipeline.run_matching(cfg, rs, ts)
    return rec, mr


def test_record_dispatches_sees_every_stage(recorded):
    rec, mr = recorded
    assert len(mr.read_row) > 0
    stages = {p.stage for p in rec.programs.values()}
    assert {"probe", "expand", "verify", "rank"} <= stages
    (exp,) = rec.by_stage("expand")
    assert exp.kwargs["pair_cap"] >= int(exp.last_out[5]) > 0
    assert exp.args[0].shape[0] == 4 * rec.by_stage("probe")[0].args[0].shape[0]
    for p in rec.programs.values():
        assert p.calls >= 1 and p.compile_s >= 0.0


def test_record_dispatches_restores_the_engine(recorded):
    from muscato_tpu.ops import fused

    assert fused._jit.__module__ == "muscato_tpu.ops.fused"


def test_memory_analysis_of_recorded_programs(recorded):
    rec, _ = recorded
    (rank,) = rec.by_stage("rank")
    mem = rank.memory_analysis()
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes", "generated_code_size_in_bytes"}
    surv_cap = rank.kwargs["surv_cap"]
    assert mem["argument_size_in_bytes"] >= surv_cap * 7 * 4


def test_memory_analysis_reuses_the_runs_executables(recorded):
    rec, _ = recorded
    compiles = []

    def on_duration(event, secs, **kw):
        if event == "/jax/core/compile/backend_compile_duration":
            compiles.append(kw.get("fun_name"))

    jax.monitoring.register_event_duration_secs_listener(on_duration)
    try:
        for p in rec.programs.values():
            p.memory_analysis()
    finally:
        jax.monitoring.unregister_event_duration_listener(on_duration)
    assert compiles == []


def test_chip_smoke_reports_each_program(recorded, capsys):
    rec, _ = recorded
    chip_smoke.report_programs(rec)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(rec.programs)
    for stage in ("probe", "expand", "verify", "rank"):
        assert any(ln.startswith(f"compile {stage}: ") and "temp_size_in_bytes"
                   in ln for ln in lines)


def test_chip_smoke_requires_every_stage():
    with pytest.raises(chip_smoke.SmokeError, match="dispatched no"):
        chip_smoke.report_programs(Dispatches())


_TRACE = """
planes {
  id: 1
  name: "/device:GPU:0"
  lines {
    id: 1
    name: "Stream #13(Compute)"
    timestamp_ns: 0
    events { metadata_id: 1 offset_ps: 0 duration_ps: 4000000
             stats { metadata_id: 1 str_value: "jit__probe_windows_impl" } }
    events { metadata_id: 2 offset_ps: 4000000 duration_ps: 1000000
             stats { metadata_id: 1 str_value: "jit__probe_windows_impl" } }
    events { metadata_id: 3 offset_ps: 8000000 duration_ps: 2000000
             stats { metadata_id: 1 str_value: "jit__rank_survivors_impl" } }
  }
  lines {
    id: 2
    name: "Stream #14(MemcpyH2D)"
    timestamp_ns: 0
    events { metadata_id: 4 offset_ps: 0 duration_ps: 500000 }
  }
  event_metadata { key: 1 value { id: 1 name: "sort_10_1" } }
  event_metadata { key: 2 value { id: 2 name: "sort_10_1__7" } }
  event_metadata { key: 3 value { id: 3 name: "sort_20_1" } }
  event_metadata { key: 4 value { id: 4 name: "MemcpyH2D" } }
  stat_metadata { key: 1 value { id: 1 name: "hlo_module" } }
}
planes { id: 2 name: "/host:CPU" }
"""


def test_summarize_trace_reduces_the_busiest_stream():
    s = stage_profile.summarize_trace(ProfileData.from_text_proto(_TRACE))
    assert s["stream"] == "Stream #13(Compute)"
    assert s["kernel_ms"] == pytest.approx(7e-3)
    assert s["busy_ms"] == pytest.approx(7e-3)
    assert s["span_ms"] == pytest.approx(10e-3)
    assert s["idle_share"] == pytest.approx(0.3)
    assert s["by_program_ms"] == pytest.approx(
        {"jit__probe_windows_impl": 5e-3, "jit__rank_survivors_impl": 2e-3})
    assert s["top_kernels"][0][0] == "sort_10_1"
    assert s["top_kernels"][0][1:] == [pytest.approx(5e-3), 2]


def test_summarize_trace_needs_a_gpu_kernel():
    cpu_only = 'planes { id: 2 name: "/host:CPU" }'
    with pytest.raises(ValueError, match="no GPU kernel"):
        stage_profile.summarize_trace(ProfileData.from_text_proto(cpu_only))


def test_merged_busy_counts_overlap_once():
    assert stage_profile._merged_busy_ns([(0, 4), (2, 6), (8, 9), (8, 9)]) == 7


def test_ab_orders_alternate():
    assert stage_profile.ab_orders(3) == [0, 1, 1, 0, 0, 1]
    assert stage_profile.ab_orders(2).count(0) == 2
