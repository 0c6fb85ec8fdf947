"""The persistent compilation cache: JAX_COMPILATION_CACHE_DIR when set,
otherwise one fixed, git-ignored directory inside the checkout."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODE = ("import jax; from muscato_tpu.engine.driver import "
        "enable_compile_cache; d = enable_compile_cache(); "
        "print(d); print(jax.config.jax_compilation_cache_dir)")


def _run(cwd, **extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **extra)
    r = subprocess.run([sys.executable, "-c", CODE], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout.split()


def test_compile_cache_env_set(tmp_path):
    want = str(tmp_path / "cache")
    assert _run(str(tmp_path), JAX_COMPILATION_CACHE_DIR=want) == [want, want]


def test_compile_cache_env_unset_is_fixed(tmp_path):
    a = tmp_path / "a"
    b = tmp_path / "b"
    a.mkdir()
    b.mkdir()
    got_a = _run(str(a))
    got_b = _run(str(b))
    want = os.path.join(REPO, ".jax_cache")
    assert got_a == got_b == [want, want]
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
