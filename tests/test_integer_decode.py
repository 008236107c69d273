"""decode_mode='integer' (stream format v2): order-free mod-2^32 integer
reconstruction — the order-free decode path."""

import dataclasses

import numpy as np
import pytest

from hsc_tpu import CodecConfig, MultilevelDictionary, SignalGenerator, make_test_config
from hsc_tpu.oracle.mp import (
    LevelStream,
    mp_decode,
    mp_decode_integer,
    mp_encode,
    rep_quantize,
)
from hsc_tpu.runtime import CorpusEncoder
from hsc_tpu.utils import snr_db


def _streams(mld, nb=3, seed=3):
    cfg = mld.config
    xs = SignalGenerator(mld, rates=4e-3).generate_signals(
        nb, cfg.block_size, seed=seed
    )
    return [
        mp_encode(
            xs[b][:, None],
            mld.augmented(0),
            mld.gram(0),
            num_coefs=cfg.num_coefs[0],
            amp_bits=cfg.amp_bits,
        )
        for b in range(nb)
    ], xs


def test_oracle_vs_xla_bitwise(mld1):
    """Single-block XLA integer decode is bitwise the oracle's."""
    import jax.numpy as jnp

    from hsc_tpu.ops.decode import mp_decode_integer_jax

    cfg = mld1.config
    rep_q, step = rep_quantize(mld1.augmented(0), cfg.rep_bits)
    streams, _ = _streams(mld1)
    for s in streams:
        oracle = mp_decode_integer(s, rep_q, step, cfg.block_size)
        amp_step = np.float32(np.float32(s.scale) * np.float32(step))
        dev = mp_decode_integer_jax(
            jnp.asarray(s.positions), jnp.asarray(s.atoms),
            jnp.asarray(s.codes), jnp.int32(s.positions.shape[0]),
            jnp.float32(amp_step), jnp.asarray(rep_q), n=cfg.block_size,
        )
        assert np.asarray(dev).tobytes() == oracle.tobytes()


def test_batched_matches_single(mld1):
    """Batching cannot change a bit (all arithmetic is exact)."""
    import jax.numpy as jnp

    from hsc_tpu.ops.decode import mp_decode_integer_batch_jax

    cfg = mld1.config
    rep_q, step = rep_quantize(mld1.augmented(0), cfg.rep_bits)
    streams, _ = _streams(mld1, nb=4, seed=5)
    cap = max(s.positions.shape[0] for s in streams)
    nb = len(streams)
    pos = np.zeros((nb, cap), np.int32)
    atm = np.zeros((nb, cap), np.int32)
    cds = np.zeros((nb, cap), np.int32)
    cnt = np.zeros(nb, np.int32)
    amp = np.zeros(nb, np.float32)
    for b, s in enumerate(streams):
        n = s.positions.shape[0]
        pos[b, :n], atm[b, :n], cds[b, :n], cnt[b] = (
            s.positions, s.atoms, s.codes, n,
        )
        amp[b] = np.float32(np.float32(s.scale) * np.float32(step))
    out = np.asarray(
        mp_decode_integer_batch_jax(
            jnp.asarray(pos), jnp.asarray(atm), jnp.asarray(cds),
            jnp.asarray(cnt), jnp.asarray(amp), jnp.asarray(rep_q),
            n=cfg.block_size,
        )
    )
    for b, s in enumerate(streams):
        oracle = mp_decode_integer(s, rep_q, step, cfg.block_size)
        assert out[b].tobytes() == oracle.tobytes()


def test_integer_close_to_ordered(mld1):
    """rep_bits=12 quantization noise sits ~70 dB below the ordered decode —
    negligible at codec operating points."""
    cfg = mld1.config
    rep_q, step = rep_quantize(mld1.augmented(0), cfg.rep_bits)
    streams, _ = _streams(mld1)
    for s in streams:
        ordered = mp_decode(s, mld1.augmented(0), cfg.block_size)
        integer = mp_decode_integer(s, rep_q, step, cfg.block_size)
        assert snr_db(ordered[:, 0], integer[:, 0]) > 55.0


def test_wraparound_determinism():
    """Adversarial overlap forcing int32 wrap: spec says mod 2^32, and the
    XLA path reproduces the oracle bit-for-bit even when values wrap."""
    import jax.numpy as jnp

    from hsc_tpu.ops.decode import mp_decode_integer_jax

    w = 16
    rep_q = np.full((1, w, 1), 4095, np.int32)  # max-magnitude rep codes
    n = 64
    m = 512  # 512 max-code events all at position 0 -> sums ~2^35, wraps
    s = LevelStream(
        positions=np.zeros(m, np.int32),
        atoms=np.zeros(m, np.int32),
        codes=np.full(m, 32767, np.int32),
        scale=np.float32(1e-4),
        energy0=1.0,
        energy_res=1.0,
    )
    oracle = mp_decode_integer(s, rep_q, np.float32(2e-4), n)
    assert not np.all(oracle >= 0)  # wrap actually happened
    amp_step = np.float32(np.float32(s.scale) * np.float32(2e-4))
    dev = mp_decode_integer_jax(
        jnp.asarray(s.positions), jnp.asarray(s.atoms), jnp.asarray(s.codes),
        jnp.int32(m), jnp.float32(amp_step), jnp.asarray(rep_q), n=n,
    )
    assert np.asarray(dev).tobytes() == oracle.tobytes()


def _batch_arrays(streams, step, cap=None):
    import jax.numpy as jnp

    cap = cap or max(s.positions.shape[0] for s in streams)
    nb = len(streams)
    pos = np.zeros((nb, cap), np.int32)
    atm = np.zeros((nb, cap), np.int32)
    cds = np.zeros((nb, cap), np.int32)
    cnt = np.zeros(nb, np.int32)
    amp = np.zeros(nb, np.float32)
    for b, s in enumerate(streams):
        n = s.positions.shape[0]
        pos[b, :n], atm[b, :n], cds[b, :n], cnt[b] = (
            s.positions, s.atoms, s.codes, n,
        )
        amp[b] = np.float32(np.float32(s.scale) * np.float32(step))
    return tuple(jnp.asarray(a) for a in (pos, atm, cds, cnt, amp))


def test_batch_integer_bitwise(mld1):
    """The batched XLA integer decode (the one every decode surface calls)
    is bitwise the oracle — one int32 scatter-add, the same exact integer
    arithmetic in another order."""
    import jax.numpy as jnp

    from hsc_tpu.ops.decode import mp_decode_integer_batch_jax

    cfg = mld1.config
    rep_q, step = rep_quantize(mld1.augmented(0), cfg.rep_bits)
    streams, _ = _streams(mld1, nb=4, seed=5)
    args = _batch_arrays(streams, step)
    out = np.asarray(
        mp_decode_integer_batch_jax(*args, jnp.asarray(rep_q), n=cfg.block_size)
    )
    for b, s in enumerate(streams):
        oracle = mp_decode_integer(s, rep_q, step, cfg.block_size)
        assert out[b].tobytes() == oracle.tobytes()


def test_batch_integer_count_masking(mld1):
    """Events past `count` contribute nothing (cz masking)."""
    import jax.numpy as jnp

    from hsc_tpu.ops.decode import mp_decode_integer_batch_jax

    cfg = mld1.config
    rep_q, step = rep_quantize(mld1.augmented(0), cfg.rep_bits)
    streams, _ = _streams(mld1, nb=2, seed=9)
    cap = max(s.positions.shape[0] for s in streams) + 37
    pos, atm, cds, cnt, amp = _batch_arrays(streams, step, cap=cap)
    # poison the padding beyond count: decode must ignore it
    pos = pos.at[:, -5:].set(13)
    atm = atm.at[:, -5:].set(1)
    cds = cds.at[:, -5:].set(999)
    out = np.asarray(
        mp_decode_integer_batch_jax(
            pos, atm, cds, cnt, amp, jnp.asarray(rep_q), n=cfg.block_size
        )
    )
    for b, s in enumerate(streams):
        oracle = mp_decode_integer(s, rep_q, step, cfg.block_size)
        assert out[b].tobytes() == oracle.tobytes()


def test_batch_integer_wraparound():
    """The batched decode reproduces the spec's mod-2^32 wraparound."""
    import jax.numpy as jnp

    from hsc_tpu.ops.decode import mp_decode_integer_batch_jax

    w = 16
    rep_q = np.full((1, w, 1), 4095, np.int32)
    n = 64
    m = 512
    s = LevelStream(
        positions=np.zeros(m, np.int32), atoms=np.zeros(m, np.int32),
        codes=np.full(m, 32767, np.int32), scale=np.float32(1e-4),
        energy0=1.0, energy_res=1.0,
    )
    oracle = mp_decode_integer(s, rep_q, np.float32(2e-4), n)
    assert not np.all(oracle >= 0)
    amp_step = np.float32(np.float32(s.scale) * np.float32(2e-4))
    out = np.asarray(
        mp_decode_integer_batch_jax(
            jnp.asarray(s.positions)[None], jnp.asarray(s.atoms)[None],
            jnp.asarray(s.codes)[None], jnp.asarray([m], np.int32),
            jnp.asarray([amp_step], np.float32), jnp.asarray(rep_q), n=n,
        )
    )
    assert out[0].tobytes() == oracle.tobytes()


@pytest.mark.parametrize(
    "w,n,k,m", [(33, 700, 5, 50), (8, 129, 3, 200), (160, 4096, 12, 64)]
)
def test_batch_integer_odd_geometry(w, n, k, m):
    """Odd window widths, event capacities off any tile size, tail
    buckets: random streams against the oracle."""
    import jax.numpy as jnp

    from hsc_tpu.ops.decode import mp_decode_integer_batch_jax

    rng = np.random.default_rng(17 + w)
    rep_q = rng.integers(-2047, 2048, (k, w, 1)).astype(np.int32)
    npos = n - w + 1
    cnt = int(rng.integers(0, m + 1))
    s = LevelStream(
        positions=rng.integers(0, npos, m).astype(np.int32),
        atoms=rng.integers(0, k, m).astype(np.int32),
        codes=rng.integers(-32767, 32768, m).astype(np.int32),
        scale=np.float32(3e-4), energy0=1.0, energy_res=1.0,
    )
    trimmed = LevelStream(
        positions=s.positions[:cnt], atoms=s.atoms[:cnt],
        codes=s.codes[:cnt], scale=s.scale, energy0=1.0, energy_res=1.0,
    )
    oracle = mp_decode_integer(trimmed, rep_q, np.float32(1e-4), n)
    amp_step = np.float32(np.float32(s.scale) * np.float32(1e-4))
    out = np.asarray(
        mp_decode_integer_batch_jax(
            jnp.asarray(s.positions)[None], jnp.asarray(s.atoms)[None],
            jnp.asarray(s.codes)[None], jnp.asarray([cnt], np.int32),
            jnp.asarray([amp_step], np.float32), jnp.asarray(rep_q), n=n,
        )
    )
    assert out[0].tobytes() == oracle.tobytes(), f"geometry w={w} n={n}"


def test_batch_integer_multichannel():
    """Multichannel representation banks decode through the same batched
    path, bitwise the oracle per channel."""
    import jax.numpy as jnp

    from hsc_tpu.ops.decode import mp_decode_integer_batch_jax

    rng = np.random.default_rng(3)
    rep_q = rng.integers(-100, 101, (3, 8, 2)).astype(np.int32)
    s = LevelStream(
        positions=np.array([0, 5, 56], np.int32),
        atoms=np.array([2, 0, 1], np.int32),
        codes=np.array([7, -3, 11], np.int32),
        scale=np.float32(0.5), energy0=1.0, energy_res=1.0,
    )
    oracle = mp_decode_integer(s, rep_q, np.float32(0.25), 64)
    out = mp_decode_integer_batch_jax(
        jnp.asarray(s.positions)[None], jnp.asarray(s.atoms)[None],
        jnp.asarray(s.codes)[None], jnp.asarray([3], np.int32),
        jnp.asarray([np.float32(0.125)], np.float32), jnp.asarray(rep_q), n=64,
    )
    assert np.asarray(out).shape == (1, 64, 2)
    assert np.asarray(out)[0].tobytes() == oracle.tobytes()


def test_config_validation():
    with pytest.raises(ValueError, match="decode_mode"):
        make_test_config(decode_mode="bogus")
    with pytest.raises(ValueError, match="rep_bits"):
        make_test_config(decode_mode="integer", rep_bits=13)
    with pytest.raises(ValueError, match="2\\^24"):
        make_test_config(num_coefs=(1024,), amp_bits=16, decode_mode="integer")
    # flagship bound holds exactly: 512 * 32767 < 2^24
    make_test_config(num_coefs=(512,), amp_bits=16, decode_mode="integer")


def test_runtime_roundtrip_integer(mld1):
    """v2 container with decode_mode='integer': runtime decode is
    deterministic, close to the ordered decode, and the header drives the
    arithmetic (geometry-tolerant decoder)."""
    cfg_i = dataclasses.replace(mld1.config, decode_mode="integer")
    mld_i = type(mld1)(cfg_i, [d.copy() for d in mld1.dicts])
    xs = SignalGenerator(mld_i, rates=4e-3).generate_signals(
        4, cfg_i.block_size, seed=31
    )
    enc_i = CorpusEncoder(mld_i, backend="jax", batch_size=2)
    blob = enc_i.encode(xs)
    out1 = enc_i.decode(blob)
    out2 = enc_i.decode(blob)
    assert out1.tobytes() == out2.tobytes()
    for b in range(4):
        assert snr_db(xs[b], out1[b]) > 3.0
    # the ordered-mode coder decodes the same stream with the header's
    # integer arithmetic (streams are self-describing)
    enc_o = CorpusEncoder(mld1, backend="jax", batch_size=2)
    assert enc_o.decode(blob).tobytes() == out1.tobytes()
    # event payloads identical across modes: only the header differs
    blob_o = enc_o.encode(xs)
    from hsc_tpu.io import unpack_corpus

    _, blocks_i = unpack_corpus(blob)
    _, blocks_o = unpack_corpus(blob_o)
    for bi, bo in zip(blocks_i, blocks_o):
        (li, si), (lo, so) = bi[0], bo[0]
        assert (
            si.positions.tolist() == so.positions.tolist()
            and si.codes.tolist() == so.codes.tolist()
        )


def test_v1_container_still_decodes(mld1):
    """Backward compatibility: a version-1 container (no decode_mode keys in
    the header JSON) decodes with the v1 ordered arithmetic."""
    import json
    import struct

    from hsc_tpu.io import unpack_corpus
    from hsc_tpu.io.bitstream import MAGIC, pack_stream

    import dataclasses

    from hsc_tpu import MultilevelDictionary

    # ordered-mode codec: v1 semantics on both sides (the default config
    # resolves to 'integer' nowadays, which a v1 container must not inherit)
    mld1 = MultilevelDictionary(
        dataclasses.replace(mld1.config, decode_mode="ordered"), mld1.dicts
    )
    cfg = mld1.config
    xs = SignalGenerator(mld1, rates=4e-3).generate_signals(
        1, cfg.block_size, seed=33
    )
    enc = CorpusEncoder(mld1, backend="jax", batch_size=1)
    blob2 = enc.encode(xs)
    # strip the v2 keys and write a v1 container around the same payload
    d = json.loads(cfg.to_json())
    d.pop("decode_mode"), d.pop("rep_bits")
    cfg_json = json.dumps(d, sort_keys=True, separators=(",", ":")).encode()
    _, blocks = unpack_corpus(blob2)
    body = struct.pack("<I", len(blocks))
    for streams in blocks:
        body += struct.pack("<B", len(streams))
        for level, s in streams:
            body += pack_stream(cfg, level, s)
    blob1 = MAGIC + struct.pack("<BI", 1, len(cfg_json)) + cfg_json + body
    out1 = enc.decode(blob1)
    out2 = enc.decode(blob2)
    assert out1.tobytes() == out2.tobytes()  # cfg is 'ordered' either way


def test_hierarchical_integer_decode(mld2):
    """2-level dictionary under integer mode: top-level reconstruction via
    quantized representations matches the oracle spec bitwise."""
    import jax.numpy as jnp

    from hsc_tpu.models import HierarchicalConvolutionalSparseCoder
    from hsc_tpu.ops.decode import mp_decode_integer_jax

    cfg = mld2.config
    coder = HierarchicalConvolutionalSparseCoder(mld2, backend="jax")
    xs = SignalGenerator(
        mld2, rates=[np.full(12, 4e-3), np.full(8, 1e-3)]
    ).generate_signals(1, cfg.block_size, seed=35)
    streams = coder.encode(xs[0])
    top = streams[-1]
    rep_q, step = rep_quantize(
        mld2.representations(1)[:, :, None], cfg.rep_bits
    )
    oracle = mp_decode_integer(top, rep_q, step, cfg.block_size)
    out = coder.reconstruct(top, mode="integer")
    assert out.tobytes() == oracle[:, 0].tobytes()
