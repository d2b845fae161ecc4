"""Entry points outside the codec: the compile-cache helper, the
benchmark's peak table, and the GPU-only scripts refusing the CPU."""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

import bench
from audio_codec_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # nothing set


def test_compile_cache_defaults_to_repo(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(REPO / ".cache" / "jax")
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_bench_peak_known_h100():
    assert bench.peak_f32_flops("NVIDIA H100 80GB HBM3") == 67e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA H200"])
def test_bench_peak_unknown_device_raises(kind):
    with pytest.raises(ValueError, match="no f32 peak"):
        bench.peak_f32_flops(kind)


def _run(args, cwd, **env):
    return subprocess.run([sys.executable, *args], cwd=cwd, timeout=120,
                          env=dict(os.environ, **env),
                          capture_output=True, text=True)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_scripts_refuse_cpu(script):
    r = _run([script], REPO, JAX_PLATFORMS="cpu")
    assert r.returncode != 0
    assert "no GPU" in r.stderr, r.stderr[-2000:]
    assert '"ok"' not in r.stdout and "{" not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert "{" not in r.stdout, r.stdout
