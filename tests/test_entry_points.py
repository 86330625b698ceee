"""Entry-point plumbing that chooses things from what the code can observe:
make_system's memory budget (from the device's memory statistics), the
compile-cache location (from the environment), and chip_smoke.py's refusal
to run without a GPU."""

import os
import subprocess
import sys

import pytest

import reverie_tpu
from reverie_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_budget_from_device_memory_stats():
    """A device that reports `bytes_limit` gets the stated fraction of it;
    a mesh gets every device's share."""
    limit = 60 * 1024**3
    one = reverie_tpu.default_budget_bytes([_Dev({"bytes_limit": limit})])
    assert one == int(reverie_tpu.DEVICE_BUDGET_FRACTION * limit)
    four = reverie_tpu.default_budget_bytes(
        [_Dev({"bytes_limit": limit, "bytes_in_use": 0})] * 4)
    assert four == 4 * one


def test_budget_host_default_without_stats():
    """The CPU backend reports no memory statistics: the documented host
    default applies, on the real device too."""
    import jax

    assert reverie_tpu.default_budget_bytes([_Dev(None)]) == \
        reverie_tpu.HOST_BUDGET_BYTES
    assert reverie_tpu.default_budget_bytes(jax.devices()[:1]) == \
        reverie_tpu.HOST_BUDGET_BYTES


def test_explicit_budget_wins():
    """hbm_budget_bytes overrides the device-derived budget: a budget
    below the circuit's footprint makes make_system stream."""
    from reverie_tpu.backend.streaming import StreamingKKW
    from reverie_tpu.backend.tpu_host import TpuKKW, device_footprint
    from reverie_tpu.circuit.builders import mul_bench_circuit

    prog, _, _ = mul_bench_circuit(200)
    fits = reverie_tpu.make_system(prog)
    assert isinstance(fits, TpuKKW)
    fp = device_footprint(fits.cc, 256)
    streamed = reverie_tpu.make_system(prog, hbm_budget_bytes=fp // 2)
    assert isinstance(streamed, StreamingKKW)
    assert len(streamed.segments) > 1


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_location(env_dir, tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR, when set, is left to JAX and nothing is
    configured; otherwise the cache is <repo>/.jax_cache."""
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        assert compile_cache.enable_compile_cache() == \
            os.path.join(REPO, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir",
                          os.path.join(REPO, ".jax_cache"))]
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / env_dir))
        assert compile_cache.enable_compile_cache() == str(tmp_path / env_dir)
        assert calls == []


def test_chip_smoke_refuses_cpu():
    """Without a GPU chip_smoke.py exits nonzero before any phase and
    prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "[cli]" not in r.stdout
