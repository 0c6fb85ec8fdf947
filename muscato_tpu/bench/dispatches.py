"""What the engine's device stages dispatched, seen from outside the engine.

`record_dispatches()` wraps `ops.fused._jit`, the one place every device
stage of the single-device engine (probe, expand, verify, rank and the
streaming variants) gets its jitted program.  For each distinct program a
run calls it records the argument specs and static arguments of its first
call and the backend compile seconds JAX reports during that call (a
persistent-cache hit shows as a short load).  `memory_analysis()` then
lowers the same jitted object at those specs, which finds the executable
the run compiled, so compile time and memory figures belong to the
executables the run itself used.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax

from ..ops import fused

BACKEND_COMPILE = "/jax/core/compile/backend_compile_duration"
CACHE_HIT = "/jax/compilation_cache/cache_hits"

# ops.fused programs by the stage name the engine's logs use.
STAGE_OF = {
    "_probe_windows_impl": "probe",
    "_probe_windows_search_impl": "probe",
    "_probe_windows_direct_impl": "probe",
    "_expand_pairs_impl": "expand",
    "_verify_diagonals_impl": "verify",
    "_expand_verify_impl": "expand_verify",
    "_rank_survivors_impl": "rank",
}


@dataclass
class Program:
    fn_name: str
    jitted: object
    args: tuple
    kwargs: dict
    calls: int = 0
    compile_s: float = 0.0
    cache_hits: int = 0
    first_call_s: float = 0.0
    last_out: object = None

    @property
    def stage(self) -> str:
        return STAGE_OF.get(self.fn_name, self.fn_name)

    def memory_analysis(self) -> dict:
        """Sizes, in bytes, from the compiled executable of this program."""
        compiled = self.jitted.lower(*self.args, **self.kwargs).compile()
        ma = compiled.memory_analysis()
        return {k: int(getattr(ma, k)) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")}


@dataclass
class Dispatches:
    programs: dict = field(default_factory=dict)

    def by_stage(self, stage: str) -> list:
        return [p for p in self.programs.values() if p.stage == stage]


def _spec(x):
    if isinstance(x, jax.Array):
        # A one-device spec carries no sharding: lowered with one, the
        # program would miss the dispatch's executable and compile again.
        sh = x.sharding if len(x.sharding.device_set) > 1 else None
        return jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=sh)
    return x


def _key(fn_name, args, kwargs):
    shapes = tuple(
        (a.shape, str(a.dtype)) if isinstance(a, jax.ShapeDtypeStruct) else a
        for a in args
    )
    return fn_name, shapes, repr(sorted(kwargs.items()))


@contextlib.contextmanager
def record_dispatches(keep_outputs: bool = False):
    """Record every ops.fused program dispatched inside the block.  With
    keep_outputs, each program keeps its last call's outputs (device
    arrays) until the Dispatches object is dropped."""
    rec = Dispatches()
    events: list = []

    def on_duration(event, secs, **kw):
        if event == BACKEND_COMPILE:
            events.append((kw.get("fun_name"), secs))

    def on_event(event, **kw):
        if event == CACHE_HIT:
            events.append((CACHE_HIT, 0.0))

    orig = fused._jit

    def jit(fn, static):
        jitted = orig(fn, static)

        def call(*args, **kwargs):
            n0 = len(events)
            t0 = time.perf_counter()
            out = jitted(*args, **kwargs)
            dt = time.perf_counter() - t0
            specs = tuple(_spec(a) for a in args)
            skw = {k: _spec(v) for k, v in kwargs.items()}
            key = _key(fn.__name__, specs, skw)
            prog = rec.programs.get(key)
            if prog is None:
                prog = rec.programs[key] = Program(
                    fn.__name__, jitted, specs, skw, first_call_s=dt)
            prog.calls += 1
            mine = f"jit({fn.__name__})"
            prog.compile_s += sum(s for n, s in events[n0:] if n == mine)
            prog.cache_hits += sum(1 for n, _ in events[n0:] if n == CACHE_HIT)
            if keep_outputs:
                prog.last_out = out
            return out

        return call

    fused._jit = jit
    jax.monitoring.register_event_duration_secs_listener(on_duration)
    jax.monitoring.register_event_listener(on_event)
    try:
        yield rec
    finally:
        fused._jit = orig
        jax.monitoring.unregister_event_duration_listener(on_duration)
        jax.monitoring.unregister_event_listener(on_event)
