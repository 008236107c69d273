"""The greedy MP loop's routes: the XLA loop against the pinned oracle across
geometries, the CUDA kernel wrapper's host-side arithmetic (segments, shared
memory, attributes), the route choice, and — on a GPU only — the CUDA kernel
against the XLA loop."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from hsc_tpu import MultilevelDictionary, SignalGenerator, make_test_config
from hsc_tpu.models import ConvolutionalSparseCoder
from hsc_tpu.models.coder import ConvolutionalMatchingPursuit
from hsc_tpu.ops import greedy_cuda
from hsc_tpu.ops.encode import batched_loop_for, encode_init_batched, quantizer_steps
from hsc_tpu.ops.route import greedy_loop, greedy_loop_route
from pinned import oracle_encode_pinned

FLAGSHIP_NPOS = 16384 - 32 + 1


def _batch_encode(mld, xs, route="xla", **overrides):
    """Init -> host quantizer -> loop on `route`, with the coder's settings."""
    cfg = mld.config
    mp = ConvolutionalMatchingPursuit(
        mld.augmented(0), mld.gram(0), num_coefs=cfg.num_coefs[0],
        amp_bits=cfg.amp_bits, tolerance_snr=cfg.tolerance_snr,
        n_raw=cfg.counts[0], num_select=cfg.num_select, backend="jax",
    )
    settings = {**mp.settings, **overrides}
    s0, e0, peak = encode_init_batched(jnp.asarray(xs, jnp.float32)[:, :, None], mp.bank)
    scale, inv = quantizer_steps(np.asarray(peak), settings["amp_bits"])
    return greedy_loop(route, settings)(
        s0, e0, jnp.asarray(scale), jnp.asarray(inv), mp.bank, mp.gram_t
    )


def _assert_matches_oracle(enc, xs, mld, msg="", **overrides):
    for b in range(xs.shape[0]):
        ref = oracle_encode_pinned(xs[b][:, None], mld, 0, **overrides)
        n = int(enc.count[b])
        assert n == ref.positions.shape[0], msg
        np.testing.assert_array_equal(np.asarray(enc.positions[b][:n]), ref.positions, msg)
        np.testing.assert_array_equal(np.asarray(enc.atoms[b][:n]), ref.atoms, msg)
        np.testing.assert_array_equal(np.asarray(enc.codes[b][:n]), ref.codes, msg)
        assert np.float32(enc.scale[b]) == ref.scale, msg
        # the fixed-shape buffers are zero past the valid prefix
        assert not np.asarray(enc.codes[b][n:]).any(), msg


GEOMETRIES = {
    # name: (config overrides, loop overrides, signal rate)
    "unaligned_atom_count": (dict(counts=(13,), scales=(16,), num_coefs=(48,)), {}, 4e-3),
    "wide_window": (dict(counts=(8,), scales=(160,), num_coefs=(24,), block_size=2048), {}, 2e-3),
    "wide_window_short_block": (
        dict(counts=(8,), scales=(160,), num_coefs=(16,), block_size=280), {}, 2e-2),
    "snr_stop": (dict(num_coefs=(64,), tolerance_snr=8.0), {}, 4e-3),
    "singleton_weights": (dict(counts=(12,), num_coefs=(40,)),
                          dict(singleton_weight=0.9, n_raw=10), 4e-3),
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_xla_loop_geometry_matches_oracle(name):
    cfg_kw, loop_kw, rate = GEOMETRIES[name]
    cfg = make_test_config(**cfg_kw)
    mld = MultilevelDictionary.generate(cfg, seed=33)
    xs = SignalGenerator(mld, rates=rate).generate_signals(2, cfg.block_size, seed=92)
    enc = _batch_encode(mld, xs, **loop_kw)
    _assert_matches_oracle(enc, xs, mld, name, **loop_kw)


@pytest.mark.parametrize("ns", [2, 3, 4, 8, 16])
def test_xla_multi_select_matches_oracle(mld1, ns):
    xs = SignalGenerator(mld1, rates=4e-3).generate_signals(2, mld1.config.block_size, seed=91)
    enc = _batch_encode(mld1, xs, num_select=ns)
    _assert_matches_oracle(enc, xs, mld1, f"ns={ns}", num_select=ns)


def test_xla_loop_zero_signal(mld1):
    xs = np.zeros((1, mld1.config.block_size), np.float32)
    enc = _batch_encode(mld1, xs, num_coefs=16)
    assert int(enc.count[0]) == 0
    assert float(enc.scale[0]) == 0.0
    assert not np.asarray(enc.codes).any()


def test_bad_num_select_refused():
    with pytest.raises(ValueError, match="num_select"):
        greedy_loop_route("gpu", npos=1009, k=16, w=16, num_select=0)


@pytest.mark.parametrize("seed", range(18))
def test_xla_loop_fuzz_matches_oracle(seed):
    """Random geometries, sweep widths and SNR stops through the batched
    loop every route shares its contract with."""
    rng = np.random.default_rng(seed + 500)
    k = int(rng.integers(3, 20))
    w = int(rng.integers(6, 60))
    block = int(rng.integers(w * 4, 1536))
    nc = int(rng.integers(8, 48))
    ns = int(rng.choice([1, 2, 3, 4, 8]))
    tol = 6.0 if seed % 2 else None
    cfg = make_test_config(
        counts=(k,), scales=(w,), num_coefs=(nc,), block_size=block,
        num_select=ns, tolerance_snr=tol,
    )
    mld = MultilevelDictionary.generate(cfg, seed=seed + 300)
    gen = SignalGenerator(mld, rates=float(rng.uniform(2e-3, 2e-2)))
    xs = gen.generate_signals(2, block, seed=seed)
    enc = _batch_encode(mld, xs)
    _assert_matches_oracle(enc, xs, mld, f"k={k} w={w} block={block} ns={ns}")


@pytest.mark.parametrize("ns", range(1, 17))
def test_segment_length(ns):
    """Segments are the spec's 128-aligned lengths and S of them cover the
    flagship position axis."""
    seg = greedy_cuda.segment_length(FLAGSHIP_NPOS, ns)
    if ns == 1:
        assert seg == FLAGSHIP_NPOS
        return
    # the least multiple of 128 whose S segments cover the axis
    assert seg % 128 == 0
    assert seg * ns >= FLAGSHIP_NPOS > (seg - 128) * ns


@pytest.mark.parametrize(
    "npos,k,w,ns,fits",
    [
        (FLAGSHIP_NPOS, 64, 32, 1, True),  # flat flagship
        (FLAGSHIP_NPOS, 64, 32, 8, True),
        (16353 - 65 + 1, 96, 65, 8, True),  # two-level flagship, level 1
        (56000, 64, 32, 1, True),  # ~219 KiB of cache: the edge
        (58000, 64, 32, 1, False),
        (1000, 16, 600, 1, True),  # lag > threads: partials span the lag
    ],
)
def test_shared_memory_fit(npos, k, w, ns, fits):
    need = greedy_cuda.shared_memory_bytes(npos, k, w, ns)
    assert need == 4 * (npos + max(2 * w - 1, greedy_cuda.THREADS) + k + 2 * ns)
    assert greedy_cuda.fits_shared_memory(npos, k, w, ns) is fits
    assert (need <= greedy_cuda.SHARED_LIMIT) is fits


@pytest.mark.parametrize(
    "platform,npos,backend,want",
    [
        ("cpu", FLAGSHIP_NPOS, "auto", "xla"),
        ("gpu", FLAGSHIP_NPOS, "auto", "cuda"),
        ("gpu", 60000, "auto", "xla"),  # cache does not fit shared memory
        ("gpu", FLAGSHIP_NPOS, "jax", "xla"),
        ("cpu", FLAGSHIP_NPOS, "jax", "xla"),
        ("gpu", 60000, "jax", "xla"),
        ("cpu", 60000, "auto", "xla"),
    ],
)
def test_route_choice(platform, npos, backend, want):
    kw = dict(npos=npos, k=64, w=32, num_select=8, backend=backend)
    assert greedy_loop_route(platform, **kw) == want


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_route_refuses_unknown_platform(platform):
    with pytest.raises(ValueError, match="platform"):
        greedy_loop_route(platform, npos=1009, k=16, w=16, num_select=1)


@pytest.mark.parametrize("backend", ["pallas", "pallas_interpret", "cuda", ""])
def test_unknown_backend_refused(mld1, backend):
    with pytest.raises(ValueError, match="backend"):
        ConvolutionalSparseCoder(mld1, backend=backend)


@pytest.mark.parametrize(
    "k,n_raw,sw", [(16, 16, 1.0), (24, 16, 0.9), (5, 2, 0.5)]
)
def test_selection_weights(k, n_raw, sw):
    wts = greedy_cuda.selection_weights(k, n_raw, sw)
    assert wts.dtype == np.float32 and wts.shape == (k,)
    assert (wts[:n_raw] == 1).all() and (wts[n_raw:] == np.float32(sw)).all()


@pytest.mark.parametrize("tol", [None, 6.0, 13.7])
def test_kernel_attributes(tol):
    at = greedy_cuda.kernel_attributes(
        npos=FLAGSHIP_NPOS, num_coefs=512, amp_bits=16, tolerance_snr=tol,
        num_select=8,
    )
    assert at["seg_len"] == greedy_cuda.segment_length(FLAGSHIP_NPOS, 8)
    assert at["maxcode"] == np.float32(32767)
    assert at["use_snr"] == (tol is not None)
    if tol is not None:
        # the XLA loop and the oracle round the factor to float32 the same way
        assert at["snr_factor"] == np.float32(10.0 ** (-tol / 10.0))
    assert all(isinstance(v, (np.int32, np.float32)) for v in at.values())


def test_coder_routes_xla_on_cpu(mld1, signal1):
    a = ConvolutionalSparseCoder(mld1, backend="auto")
    b = ConvolutionalSparseCoder(mld1, backend="jax")
    npos = mld1.config.num_positions(0)
    assert a.mp.route(npos) == "xla" and a.mp.route(npos, "gpu") == "cuda"
    sa, sb = a.encode(signal1), b.encode(signal1)
    np.testing.assert_array_equal(sa.positions, sb.positions)
    np.testing.assert_array_equal(sa.codes, sb.codes)
    assert sa.scale == sb.scale


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU form")


@pytest.mark.gpu
@pytest.mark.parametrize("ns", [1, 3, 8])
def test_cuda_loop_matches_xla(gpu, mld1, ns):
    xs = SignalGenerator(mld1, rates=4e-3).generate_signals(4, mld1.config.block_size, seed=95)
    kw = dict(num_select=ns, singleton_weight=0.9, n_raw=14, tolerance_snr=12.0)
    want = _batch_encode(mld1, xs, "xla", **kw)
    got = _batch_encode(mld1, xs, "cuda", **kw)
    for field in ("positions", "atoms", "codes", "count"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, field)), np.asarray(getattr(want, field))
        )


def test_batched_loop_cache_shared(mld1):
    """Coders with equal settings share one compiled loop (no per-instance
    jit closures)."""
    a = ConvolutionalSparseCoder(mld1, backend="jax").mp
    b = ConvolutionalSparseCoder(mld1, backend="jax").mp
    key = tuple(sorted(a.settings.items()))
    assert greedy_loop("xla", a.settings) is batched_loop_for(key)
    assert greedy_loop("xla", b.settings) is greedy_loop("xla", a.settings)
