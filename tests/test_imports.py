"""Every module of the package imports on the CPU, and none reaches for a
TPU: no Pallas-TPU import and no TPU compiler option."""

import importlib
import pkgutil
import sys

import pytest

import muscato_tpu

MODULES = sorted(
    m.name for m in pkgutil.walk_packages(muscato_tpu.__path__, "muscato_tpu.")
)


@pytest.mark.parametrize("name", MODULES)
def test_module_imports_without_tpu(name):
    mod = importlib.import_module(name)
    assert "jax.experimental.pallas.tpu" not in sys.modules
    with open(mod.__file__, encoding="utf-8") as f:
        src = f.read()
    for needle in ("pallas.tpu", "pltpu", "xla_tpu_"):
        assert needle not in src, (name, needle)
