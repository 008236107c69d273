"""Host utility parity tests (`hsc/utils.py` — SURVEY.md §2 C10)."""

import numpy as np
import pytest

from hsc_tpu.utils import find_grid_size, normalize, overlap_add, overlap_replace, snr_db


def test_normalize_global():
    x = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    n = normalize(x)
    assert np.isclose(np.linalg.norm(n), 1.0, atol=1e-6)


def test_normalize_axis():
    x = np.random.default_rng(1).standard_normal((5, 64)).astype(np.float32)
    n = normalize(x, axis=1)
    assert np.allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-6)


def test_normalize_zero_safe():
    n = normalize(np.zeros(8, dtype=np.float32))
    assert np.all(np.isfinite(n))


def test_overlap_add_replace():
    sig = np.zeros(16, dtype=np.float32)
    overlap_add(sig, np.ones(4, dtype=np.float32), 3)
    assert np.array_equal(np.nonzero(sig)[0], [3, 4, 5, 6])
    overlap_replace(sig, np.full(4, 2.0, dtype=np.float32), 5)
    assert sig[5] == 2.0 and sig[4] == 1.0


def test_find_grid_size():
    assert find_grid_size(1) == (1, 1)
    assert find_grid_size(6) == (2, 3)
    assert find_grid_size(16) == (4, 4)
    rows, cols = find_grid_size(17)
    assert rows * cols >= 17


def test_snr_db():
    x = np.ones(100)
    assert snr_db(x, x) == float("inf")
    noisy = x + 0.1
    assert 19 < snr_db(x, noisy) < 21


def test_profile_region_writes_trace(tmp_path):
    """SURVEY §5 tracing: profile_region collects a Perfetto trace."""
    import jax.numpy as jnp

    from hsc_tpu.utils.profiling import profile_region, scope

    with profile_region(str(tmp_path / "trace")):
        with scope("test/compute"):
            x = (jnp.arange(128.0) * 2.0).sum()
            float(x)
    files = list((tmp_path / "trace").rglob("*"))
    assert any(f.is_file() for f in files)
    # no-op path
    with profile_region(None):
        pass


@pytest.mark.parametrize("env_dir", [None, "set"])
def test_compilation_cache_dir(monkeypatch, tmp_path, env_dir):
    """`enable_compilation_cache` defers to $JAX_COMPILATION_CACHE_DIR when
    it is set (configuring nothing itself) and otherwise uses the path it is
    given (the checkout's fixed `.jax_cache/` by default)."""
    import jax

    from hsc_tpu.utils import cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
            cache.enable_compilation_cache()
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            cache.enable_compilation_cache(str(tmp_path / "own"))
            assert jax.config.jax_compilation_cache_dir == str(tmp_path / "own")
            assert (tmp_path / "own").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
