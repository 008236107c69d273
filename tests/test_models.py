"""Coder classes: batched device encode vs per-block oracle, corpus pipeline
round-trip (BASELINE.json configs 1–3 on the test scale)."""

import numpy as np

from hsc_tpu import SignalGenerator
from hsc_tpu.models import (
    ConvolutionalSparseCoder,
    HierarchicalConvolutionalSparseCoder,
)
from hsc_tpu.oracle import hierarchical_decode, mp_decode
from pinned import oracle_encode_pinned, oracle_hierarchical_pinned
from hsc_tpu.io import unpack_corpus
from hsc_tpu.utils import snr_db


def _streams_equal(a, b):
    return (
        np.array_equal(a.positions, b.positions)
        and np.array_equal(a.atoms, b.atoms)
        and np.array_equal(a.codes, b.codes)
        and np.float32(a.scale) == np.float32(b.scale)
    )


def test_single_level_encode_matches_oracle(mld1, signal1):
    coder = ConvolutionalSparseCoder(mld1)
    dev = coder.encode(signal1)
    ref = oracle_encode_pinned(signal1[:, None], mld1, 0)
    assert _streams_equal(dev, ref)


def test_single_level_reconstruct_bit_exact(mld1, signal1):
    coder = ConvolutionalSparseCoder(mld1)
    stream = coder.encode(signal1)
    dev = coder.reconstruct(stream, n=mld1.config.block_size)
    ref = mp_decode(stream, mld1.augmented(0), mld1.config.block_size)
    assert dev.tobytes() == ref.tobytes()


def test_batched_encode_matches_per_block_oracle(mld1):
    gen = SignalGenerator(mld1, rates=4e-3)
    xs = gen.generate_signals(5, mld1.config.block_size, seed=21)
    coder = ConvolutionalSparseCoder(mld1)
    streams = coder.encode_batch(xs)
    assert len(streams) == 5
    for b in range(5):
        ref = oracle_encode_pinned(xs[b][:, None], mld1, 0)
        assert _streams_equal(streams[b], ref), f"block {b}"


def test_hierarchical_encode_matches_oracle(mld2, signal2):
    coder = HierarchicalConvolutionalSparseCoder(mld2)
    dev = coder.encode(signal2)
    ref = oracle_hierarchical_pinned(signal2, mld2)
    assert len(dev) == len(ref) == 2
    for level, (d, r) in enumerate(zip(dev, ref)):
        assert _streams_equal(d, r), f"level {level}"


def test_hierarchical_reconstruct_bit_exact(mld2, signal2):
    coder = HierarchicalConvolutionalSparseCoder(mld2)
    streams = coder.encode(signal2)
    # ordered mode: bit-exact vs the v1 float oracle
    dev = coder.reconstruct(streams[-1], mode="ordered")
    ref = hierarchical_decode(streams[-1], mld2)
    assert dev.tobytes() == ref.tobytes()
    # default mode resolves to 'integer' (the capacity bound holds for the
    # test config): bit-exact vs the integer oracle
    from hsc_tpu.oracle.mp import mp_decode_integer, rep_quantize

    cfg = mld2.config
    assert cfg.decode_mode == "integer"
    top = cfg.num_levels - 1
    rep_q, step = rep_quantize(
        mld2.representations(top)[:, :, None], cfg.rep_bits
    )
    dev_i = coder.reconstruct(streams[-1])
    ref_i = mp_decode_integer(streams[-1], rep_q, step, cfg.block_size)[:, 0]
    assert dev_i.tobytes() == ref_i.tobytes()


def test_corpus_pipeline_roundtrip(mld2):
    """encode → pack → unpack → decode equals the oracle end-to-end, and the
    compressed size equals the oracle's (identical streams, fixed format)."""
    gen = SignalGenerator(mld2, rates=[np.full(12, 4e-3), np.full(8, 1e-3)])
    xs = gen.generate_signals(3, mld2.config.block_size, seed=33)
    coder = HierarchicalConvolutionalSparseCoder(mld2)
    blob = coder.encode_corpus(xs)

    # oracle-side: same encode, same packing → identical bytes
    from hsc_tpu.io import pack_corpus

    oracle_blocks = []
    for b in range(3):
        streams = oracle_hierarchical_pinned(xs[b], mld2)
        oracle_blocks.append([(1, streams[1])])
    oracle_blob = pack_corpus(mld2.config, oracle_blocks)
    assert blob == oracle_blob  # streams identical => bytes identical

    # decode side: bit-exact vs oracle decode (the default mode resolves to
    # 'integer' — the container header says so, and the decode follows it)
    from hsc_tpu.oracle.mp import mp_decode_integer, rep_quantize

    cfg = mld2.config
    assert cfg.decode_mode == "integer"
    rep_q, step = rep_quantize(
        mld2.representations(1)[:, :, None], cfg.rep_bits
    )
    decoded = coder.decode_corpus(blob)
    for b in range(3):
        ref = mp_decode_integer(
            oracle_blocks[b][0][1], rep_q, step, cfg.block_size
        )[:, 0]
        assert decoded[b].tobytes() == ref.tobytes()


def test_batched_hierarchical(mld2):
    gen = SignalGenerator(mld2, rates=[np.full(12, 4e-3), np.full(8, 1e-3)])
    xs = gen.generate_signals(4, mld2.config.block_size, seed=44)
    coder = HierarchicalConvolutionalSparseCoder(mld2)
    batched = coder.encode_batch(xs)
    for b in range(4):
        ref = oracle_hierarchical_pinned(xs[b], mld2)
        for level in range(2):
            assert _streams_equal(batched[b][level], ref[level]), (b, level)


def test_reconstruction_quality(mld1, signal1):
    coder = ConvolutionalSparseCoder(mld1)
    stream = coder.encode(signal1)
    recon = coder.reconstruct(stream, n=mld1.config.block_size)[:, 0]
    assert snr_db(signal1, recon) > 3.0


def test_decode_multichannel_banks(mld2):
    """Multichannel banks decode through the same batched XLA paths as the
    signal-space (single-channel) rep banks, in both decode modes."""
    import jax.numpy as jnp

    from hsc_tpu.ops.decode import mp_decode_integer_batch_jax

    coder = HierarchicalConvolutionalSparseCoder(mld2, backend="jax")
    top = mld2.config.num_levels - 1
    gen = SignalGenerator(mld2, rates=2e-2)
    x = gen.generate_signals(1, mld2.config.block_size, seed=55)[0]
    stream = coder.encode(x)[top]
    for lv in range(mld2.config.num_levels):
        assert coder._rep_banks[lv].shape[-1] == 1

    one = coder.reconstruct_batch_device([stream], level=top, mode="ordered")
    coder._rep_banks[top] = jnp.concatenate(
        [coder._rep_banks[top], coder._rep_banks[top]], axis=-1
    )
    two = coder.reconstruct_batch_device([stream], level=top, mode="ordered")
    assert two.shape[-1] == 2
    # each channel is the single-channel decode, byte for byte
    assert np.asarray(two)[..., 1].tobytes() == np.asarray(one)[..., 0].tobytes()

    rep_q = np.ones((3, 8, 2), np.int32)
    out2 = mp_decode_integer_batch_jax(
        jnp.zeros((1, 16), jnp.int32), jnp.zeros((1, 16), jnp.int32),
        jnp.zeros((1, 16), jnp.int32), jnp.zeros((1,), jnp.int32),
        jnp.ones((1,), jnp.float32), jnp.asarray(rep_q), n=64,
    )
    assert np.asarray(out2).shape == (1, 64, 2)


def test_hierarchical_multi_select_matches_oracle(mld2, signal2):
    """Hierarchical encode with num_select sweeps (bench.py's hier operating
    point) is bitwise the pinned oracle at every level through the routed
    loop — level >=1 sweeps run the multichannel feature-map geometry no
    single-level sweep test reaches.  chip_smoke.py pins the CUDA route."""
    import dataclasses

    from hsc_tpu import MultilevelDictionary

    cfg = mld2.config
    ns = 8
    cfgs = dataclasses.replace(cfg, num_select=ns)
    mlds = MultilevelDictionary(cfgs, [d.copy() for d in mld2.dicts])
    coder = HierarchicalConvolutionalSparseCoder(mlds, backend="auto")
    batch = coder.encode_batch(signal2[None, :])
    refs = oracle_hierarchical_pinned(signal2, mlds)
    for level in range(cfg.num_levels):
        d, r = batch[0][level], refs[level]
        np.testing.assert_array_equal(d.positions, r.positions)
        np.testing.assert_array_equal(d.atoms, r.atoms)
        np.testing.assert_array_equal(d.codes, r.codes)
        assert np.float32(d.scale) == r.scale
