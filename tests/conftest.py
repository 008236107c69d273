"""Test harness config.

Tests run on CPU with 8 virtual XLA devices so data-parallel / sharded paths
are exercised without several cards (SURVEY.md §4 "what the rebuild must
add" (b)).  Must be set before the first jax import anywhere in the test
process.  Tests of CUDA kernels carry the `gpu` marker and skip here (the
decision is made in a fixture, never at import).
"""

import os

# jax may already be imported (and JAX_PLATFORMS read) by the time this runs,
# so also pin the platform through jax.config before any backend starts.
# The suite runs on the CPU; JAX_PLATFORMS=cuda opts in to a GPU, which is
# how the `gpu`-marked tests run on the card.
PLATFORM = "cuda" if os.environ.get("JAX_PLATFORMS") in ("cuda", "gpu") else "cpu"
os.environ["JAX_PLATFORMS"] = PLATFORM
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", PLATFORM)

import numpy as np
import pytest

from hsc_tpu import CodecConfig, MultilevelDictionary, SignalGenerator, make_test_config


@pytest.fixture(scope="session")
def cfg1() -> CodecConfig:
    """Small single-level config."""
    return make_test_config()


@pytest.fixture(scope="session")
def mld1(cfg1) -> MultilevelDictionary:
    return MultilevelDictionary.generate(cfg1, seed=7)


@pytest.fixture(scope="session")
def cfg2() -> CodecConfig:
    """Small two-level (hierarchical) config."""
    return make_test_config(
        counts=(12, 8), scales=(16, 48), num_coefs=(96, 48), block_size=1024
    )


@pytest.fixture(scope="session")
def mld2(cfg2) -> MultilevelDictionary:
    return MultilevelDictionary.generate(cfg2, seed=11)


@pytest.fixture(scope="session")
def signal1(mld1) -> np.ndarray:
    gen = SignalGenerator(mld1, rates=4e-3)
    return gen.generate_signals(1, mld1.config.block_size, seed=3)[0]


@pytest.fixture(scope="session")
def signal2(mld2) -> np.ndarray:
    gen = SignalGenerator(mld2, rates=[np.full(12, 4e-3), np.full(8, 1e-3)])
    return gen.generate_signals(1, mld2.config.block_size, seed=5)[0]
