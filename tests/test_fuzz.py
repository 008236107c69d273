"""Randomized cross-checks: many small random configs through the full
oracle<->device<->bitstream pipeline (SURVEY.md §4 golden-vector strategy,
fuzz form)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from hsc_tpu import CodecConfig, MultilevelDictionary, SignalGenerator
from hsc_tpu.io import pack_corpus, unpack_corpus
from hsc_tpu.models import ConvolutionalSparseCoder
from hsc_tpu.oracle import mp_decode
from pinned import oracle_encode_pinned


@pytest.mark.parametrize("seed", range(16))
def test_fuzz_single_level_pipeline(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(3, 24))
    # wide atom windows (W > 129) every 5th seed, with blocks down to <2W
    # (windows that span most of the position axis)
    if seed % 5 == 4:
        w = int(rng.integers(130, 220))
        block = int(rng.integers(w * 7 // 4, w * 6))
    else:
        w = int(rng.integers(6, 40))
        block = int(rng.integers(w * 4, 2048))
    nc = int(rng.integers(4, 80))
    amp_bits = int(rng.integers(6, 17))
    entropy = "rice" if seed % 2 else "fixed"
    ns = int(rng.choice([1, 1, 2, 3, 8]))
    tol = float(rng.uniform(3.0, 20.0)) if seed % 3 == 0 else None
    cfg = CodecConfig(
        counts=(k,), scales=(w,), num_coefs=(nc,), block_size=block,
        amp_bits=amp_bits, num_select=ns, entropy=entropy,
        tolerance_snr=tol,
    )
    mld = MultilevelDictionary.generate(cfg, seed=seed + 100, max_correlation=0.98)
    gen = SignalGenerator(mld, rates=float(rng.uniform(1e-3, 2e-2)))
    x = gen.generate_signals(1, block, seed=seed)[0]

    coder = ConvolutionalSparseCoder(mld, backend="jax")
    dev = coder.encode(x)
    ref = oracle_encode_pinned(x[:, None], mld, 0)
    assert np.array_equal(dev.positions, ref.positions), cfg
    assert np.array_equal(dev.atoms, ref.atoms), cfg
    assert np.array_equal(dev.codes, ref.codes), cfg
    assert np.float32(dev.scale) == ref.scale

    # serialize, round trip, decode bit-exact on both backends
    blob = pack_corpus(cfg, [[(0, dev)]])
    cfg2, blocks = unpack_corpus(blob)
    assert cfg2 == cfg
    stream = blocks[0][0][1]
    a = mp_decode(stream, mld.augmented(0), block)
    b = coder.reconstruct(stream, n=block)
    assert a.tobytes() == b.tobytes(), cfg


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_hierarchical_pipeline(seed):
    from hsc_tpu.models import HierarchicalConvolutionalSparseCoder
    from pinned import oracle_hierarchical_pinned
    from hsc_tpu.oracle import hierarchical_decode

    rng = np.random.default_rng(1000 + seed)
    k0 = int(rng.integers(4, 14))
    k1 = int(rng.integers(3, 8))
    w0 = int(rng.integers(8, 20))
    s1 = int(w0 + rng.integers(8, 40))
    block = int(rng.integers(s1 * 4, 1536))
    cfg = CodecConfig(
        counts=(k0, k1), scales=(w0, s1),
        num_coefs=(int(rng.integers(8, 48)), int(rng.integers(4, 24))),
        block_size=block,
        entropy="rice" if seed % 2 else "fixed",
        singleton_weight=float(rng.uniform(0.5, 1.0)),
        num_select=int(rng.choice([1, 1, 2])),
    )
    mld = MultilevelDictionary.generate(cfg, seed=seed + 5, max_correlation=0.98)
    gen = SignalGenerator(mld, rates=float(rng.uniform(2e-3, 1e-2)))
    x = gen.generate_signals(1, block, seed=seed)[0]

    coder = HierarchicalConvolutionalSparseCoder(mld, backend="jax")
    dev = coder.encode(x)
    ref = oracle_hierarchical_pinned(x, mld)
    for level in range(2):
        assert np.array_equal(dev[level].positions, ref[level].positions), cfg
        assert np.array_equal(dev[level].codes, ref[level].codes), cfg

    # decode bit-exact device vs oracle (both modes: ordered vs the float
    # oracle, and the default — resolved 'integer' — vs the integer oracle)
    a = coder.reconstruct(dev[1], mode="ordered")
    b = hierarchical_decode(dev[1], mld)
    assert a.tobytes() == b.tobytes(), cfg
    from hsc_tpu.oracle.mp import mp_decode_integer, rep_quantize

    rep_q, step = rep_quantize(mld.representations(1)[:, :, None], cfg.rep_bits)
    ai = coder.reconstruct(dev[1])
    bi = mp_decode_integer(dev[1], rep_q, step, cfg.block_size)[:, 0]
    assert ai.tobytes() == bi.tobytes(), cfg


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_integer_decode(seed):
    """Random configs through the v2 integer-decode spec: XLA path bitwise
    vs oracle, across rep_bits / amp_bits / geometry."""
    from hsc_tpu.oracle.mp import mp_decode_integer, rep_quantize
    from hsc_tpu.ops.decode import mp_decode_integer_jax

    rng = np.random.default_rng(2000 + seed)
    k = int(rng.integers(3, 24))
    w = int(rng.integers(6, 40))
    block = int(rng.integers(w * 4, 2048))
    nc = int(rng.integers(4, 80))
    amp_bits = int(rng.integers(6, 16))
    rep_bits = int(rng.integers(2, 13))
    cfg = CodecConfig(
        counts=(k,), scales=(w,), num_coefs=(nc,), block_size=block,
        amp_bits=amp_bits, decode_mode="integer", rep_bits=rep_bits,
    )
    mld = MultilevelDictionary.generate(cfg, seed=seed + 300, max_correlation=0.98)
    gen = SignalGenerator(mld, rates=float(rng.uniform(1e-3, 2e-2)))
    x = gen.generate_signals(1, block, seed=seed)[0]
    coder = ConvolutionalSparseCoder(mld, backend="jax")
    stream = coder.encode(x)
    rep_q, step = rep_quantize(mld.augmented(0), rep_bits)
    oracle = mp_decode_integer(stream, rep_q, step, block)
    n = stream.positions.shape[0]
    pad = max(nc, 1)
    pos = np.zeros(pad, np.int32); atm = np.zeros(pad, np.int32)
    cds = np.zeros(pad, np.int32)
    pos[:n], atm[:n], cds[:n] = stream.positions, stream.atoms, stream.codes
    amp_step = np.float32(np.float32(stream.scale) * np.float32(step))
    dev = mp_decode_integer_jax(
        jnp.asarray(pos), jnp.asarray(atm), jnp.asarray(cds), jnp.int32(n),
        jnp.float32(amp_step), jnp.asarray(rep_q), n=block,
    )
    assert np.asarray(dev).tobytes() == oracle.tobytes(), cfg


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_integer_batch(seed):
    """Random configs through the BATCHED integer decode (the path every
    decode surface calls): bitwise vs oracle across rep_bits / amp_bits /
    geometry, including wide windows and unaligned event capacities."""
    from hsc_tpu.oracle.mp import mp_decode_integer, rep_quantize
    from hsc_tpu.ops.decode import mp_decode_integer_batch_jax

    rng = np.random.default_rng(4000 + seed)
    k = int(rng.integers(3, 24))
    w = int(rng.integers(130, 200)) if seed % 3 == 2 else int(rng.integers(6, 40))
    block = int(rng.integers(w * 4, w * 30))
    nc = int(rng.integers(4, 80))
    amp_bits = int(rng.integers(6, 16))
    rep_bits = int(rng.integers(2, 13))
    cfg = CodecConfig(
        counts=(k,), scales=(w,), num_coefs=(nc,), block_size=block,
        amp_bits=amp_bits, decode_mode="integer", rep_bits=rep_bits,
    )
    mld = MultilevelDictionary.generate(cfg, seed=seed + 400, max_correlation=0.98)
    gen = SignalGenerator(mld, rates=float(rng.uniform(1e-3, 2e-2)))
    xs = gen.generate_signals(2, block, seed=seed)
    coder = ConvolutionalSparseCoder(mld, backend="jax")
    streams = [coder.encode(x) for x in xs]
    rep_q, step = rep_quantize(mld.augmented(0), rep_bits)
    cap = max(nc, 1) + int(rng.integers(0, 100))  # un-aligned capacities
    pos = np.zeros((2, cap), np.int32)
    atm = np.zeros((2, cap), np.int32)
    cds = np.zeros((2, cap), np.int32)
    cnt = np.zeros(2, np.int32)
    amp = np.zeros(2, np.float32)
    for b, s in enumerate(streams):
        n = s.positions.shape[0]
        pos[b, :n], atm[b, :n], cds[b, :n], cnt[b] = (
            s.positions, s.atoms, s.codes, n,
        )
        amp[b] = np.float32(np.float32(s.scale) * np.float32(step))
    out = np.asarray(
        mp_decode_integer_batch_jax(
            jnp.asarray(pos), jnp.asarray(atm), jnp.asarray(cds),
            jnp.asarray(cnt), jnp.asarray(amp), jnp.asarray(rep_q), n=block,
        )
    )
    for b, s in enumerate(streams):
        oracle = mp_decode_integer(s, rep_q, step, block)
        assert out[b].tobytes() == oracle.tobytes(), cfg


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_distributed_containers(seed):
    """Random 2-level configs through the --distributed runtime: container
    round-trips deterministically and the merged events equal top-only."""
    from hsc_tpu.oracle.mp import to_top_level
    from hsc_tpu.runtime import CorpusEncoder

    rng = np.random.default_rng(3000 + seed)
    k0 = int(rng.integers(4, 14))
    k1 = int(rng.integers(3, 8))
    w0 = int(rng.integers(8, 20))
    s1 = int(w0 + rng.integers(8, 40))
    block = int(rng.integers(s1 * 4, 1536))
    cfg = CodecConfig(
        counts=(k0, k1), scales=(w0, s1),
        num_coefs=(int(rng.integers(8, 48)), int(rng.integers(4, 24))),
        block_size=block,
        entropy="rice" if seed % 2 else "fixed",
        decode_mode="integer" if seed % 2 == 0 else "ordered",
    )
    mld = MultilevelDictionary.generate(cfg, seed=seed + 7, max_correlation=0.98)
    gen = SignalGenerator(mld, rates=float(rng.uniform(2e-3, 1e-2)))
    xs = gen.generate_signals(3, block, seed=seed)
    top = CorpusEncoder(mld, backend="jax", batch_size=2)
    dist = CorpusEncoder(mld, backend="jax", batch_size=2, distributed=True)
    blob_t = top.encode(xs)
    blob_d = dist.encode(xs)
    _, blocks_t = unpack_corpus(blob_t)
    cfg_d, blocks_d = unpack_corpus(blob_d)
    key = lambda s: sorted(
        zip(s.positions.tolist(), s.atoms.tolist(), s.codes.tolist())
    )
    for bt, bd in zip(blocks_t, blocks_d):
        assert key(to_top_level(cfg_d, bd, level=bt[0][0])) == key(bt[0][1])
    d1 = dist.decode(blob_d)
    assert d1.tobytes() == dist.decode(blob_d).tobytes()
