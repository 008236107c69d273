"""Bitstream format round-trip + size accounting (net-new vs reference —
SURVEY.md §1 note: the reference's entropy stage never serializes)."""

import numpy as np

from hsc_tpu.io import pack_corpus, pack_stream, stream_num_bytes, unpack_corpus
from hsc_tpu.io.bitstream import _pack_bits, _unpack_bits
from hsc_tpu.oracle import hierarchical_encode, mp_decode
from hsc_tpu.oracle.mp import LevelStream


def test_pack_bits_roundtrip():
    rng = np.random.default_rng(0)
    widths = [11, 5, 16]
    vals = np.stack(
        [rng.integers(0, 1 << w, size=37, dtype=np.uint64) for w in widths], axis=1
    )
    data = _pack_bits(vals, widths)
    assert len(data) == (37 * 32 + 7) // 8
    out = _unpack_bits(data, 37, widths)
    np.testing.assert_array_equal(out, vals)


def test_pack_bits_empty():
    assert _pack_bits(np.zeros((0, 3), dtype=np.uint64), [4, 4, 8]) == b""


def _encode_block(signal, mld):
    return hierarchical_encode(signal, mld)


def test_stream_roundtrip(mld1, signal1):
    cfg = mld1.config
    stream = _encode_block(signal1, mld1)[0]
    data = pack_stream(cfg, 0, stream)
    assert len(data) == stream_num_bytes(cfg, 0, stream.positions.shape[0])
    from hsc_tpu.io.bitstream import unpack_stream

    level, out, off = unpack_stream(cfg, data, 0)
    assert level == 0
    assert off == len(data)
    np.testing.assert_array_equal(out.positions, stream.positions)
    np.testing.assert_array_equal(out.atoms, stream.atoms)
    np.testing.assert_array_equal(out.codes, stream.codes)
    assert out.scale == stream.scale  # float32 bit-exact


def test_corpus_roundtrip_bit_exact_decode(mld1, signal1):
    """decode(unpack(pack(stream))) must be byte-identical to decode(stream)."""
    cfg = mld1.config
    stream = _encode_block(signal1, mld1)[0]
    blob = pack_corpus(cfg, [[(0, stream)]])
    cfg2, blocks = unpack_corpus(blob)
    assert cfg2 == cfg
    (level, out), = blocks[0]
    a = mp_decode(stream, mld1.augmented(0), cfg.block_size)
    b = mp_decode(out, mld1.augmented(0), cfg.block_size)
    assert a.tobytes() == b.tobytes()


def test_corpus_multi_block_multi_level(mld2, signal2):
    cfg = mld2.config
    streams = _encode_block(signal2, mld2)
    blocks = [[(k, s) for k, s in enumerate(streams)], [(1, streams[1])]]
    blob = pack_corpus(cfg, blocks)
    cfg2, out = unpack_corpus(blob)
    assert len(out) == 2
    assert [lvl for lvl, _ in out[0]] == [0, 1]
    np.testing.assert_array_equal(out[1][0][1].codes, streams[1].codes)


def test_negative_codes_roundtrip(mld1):
    cfg = mld1.config
    stream = LevelStream(
        positions=np.array([0, 5, 900], dtype=np.int32),
        atoms=np.array([0, 15, 7], dtype=np.int32),
        codes=np.array([-32767, 32767, -1], dtype=np.int32),
        scale=np.float32(0.01),
        energy0=1.0,
        energy_res=0.5,
    )
    blob = pack_corpus(cfg, [[(0, stream)]])
    _, blocks = unpack_corpus(blob)
    np.testing.assert_array_equal(blocks[0][0][1].codes, stream.codes)


def _rice_cfg(cfg):
    import dataclasses

    return dataclasses.replace(cfg, entropy="rice")


def test_rice_roundtrip_sorted(mld1, signal1):
    """Rice streams round-trip exactly, with events in position order."""
    import dataclasses

    cfg = _rice_cfg(mld1.config)
    stream = _encode_block(signal1, mld1)[0]
    data = pack_stream(cfg, 0, stream)
    from hsc_tpu.io.bitstream import unpack_stream

    level, out, off = unpack_stream(cfg, data, 0)
    assert off == len(data)
    order = np.argsort(stream.positions, kind="stable")
    np.testing.assert_array_equal(out.positions, stream.positions[order])
    np.testing.assert_array_equal(out.atoms, stream.atoms[order])
    np.testing.assert_array_equal(out.codes, stream.codes[order])
    assert out.scale == stream.scale
    # positions come out sorted
    assert np.all(np.diff(out.positions) >= 0)


def test_rice_smaller_than_fixed(mld1, signal1):
    cfg = mld1.config
    stream = _encode_block(signal1, mld1)[0]
    fixed = pack_stream(cfg, 0, stream)
    rice = pack_stream(_rice_cfg(cfg), 0, stream)
    assert len(rice) < len(fixed), (len(rice), len(fixed))


def test_rice_extreme_deltas(mld1):
    """Escape path: events clustered then a huge gap."""
    cfg = _rice_cfg(mld1.config)
    stream = LevelStream(
        positions=np.array([0, 1, 2, 1000, 1001], dtype=np.int32),
        atoms=np.array([3, 1, 0, 15, 2], dtype=np.int32),
        codes=np.array([100, -5, 32767, -32767, 1], dtype=np.int32),
        scale=np.float32(0.5),
        energy0=1.0,
        energy_res=0.1,
    )
    data = pack_stream(cfg, 0, stream)
    from hsc_tpu.io.bitstream import unpack_stream

    _, out, off = unpack_stream(cfg, data, 0)
    assert off == len(data)
    np.testing.assert_array_equal(out.positions, stream.positions)
    np.testing.assert_array_equal(out.codes, stream.codes)


def test_rice_corpus_decode_bit_exact(mld1, signal1):
    """Full corpus round trip under rice entropy: decode of the unpacked
    (sorted) stream is deterministic and identical across backends."""
    import dataclasses
    import jax.numpy as jnp
    from hsc_tpu.ops import mp_decode_jax

    cfg = _rice_cfg(mld1.config)
    stream = _encode_block(signal1, mld1)[0]
    blob = pack_corpus(cfg, [[(0, stream)]])
    cfg2, blocks = unpack_corpus(blob)
    assert cfg2 == cfg
    (level, out), = blocks[0]
    a = mp_decode(out, mld1.augmented(0), cfg.block_size)
    n = out.positions.shape[0]
    pad = max(n, 1)
    pos = np.zeros(pad, np.int32); pos[:n] = out.positions
    atm = np.zeros(pad, np.int32); atm[:n] = out.atoms
    cds = np.zeros(pad, np.int32); cds[:n] = out.codes
    b = np.asarray(mp_decode_jax(
        jnp.asarray(pos), jnp.asarray(atm), jnp.asarray(cds),
        jnp.int32(n), jnp.float32(out.scale), jnp.asarray(mld1.augmented(0)),
        n=cfg.block_size,
    ))
    assert a.tobytes() == b.tobytes()


def test_rice_empty_stream(mld1):
    cfg = _rice_cfg(mld1.config)
    stream = LevelStream(
        positions=np.zeros(0, np.int32), atoms=np.zeros(0, np.int32),
        codes=np.zeros(0, np.int32), scale=np.float32(0),
        energy0=0.0, energy_res=0.0,
    )
    blob = pack_corpus(cfg, [[(0, stream)]])
    _, blocks = unpack_corpus(blob)
    assert blocks[0][0][1].positions.shape[0] == 0


def test_peek_corpus_header(mld1):
    """Header-only peek agrees with the full parse without touching
    payloads."""
    from hsc_tpu import SignalGenerator
    from hsc_tpu.io import peek_corpus_header, unpack_corpus
    from hsc_tpu.runtime import CorpusEncoder

    enc = CorpusEncoder(mld1, backend="jax", batch_size=2)
    xs = SignalGenerator(mld1, rates=4e-3).generate_signals(
        3, mld1.config.block_size, seed=45
    )
    blob = enc.encode(xs)
    cfg_p, n = peek_corpus_header(blob)
    cfg_f, blocks = unpack_corpus(blob)
    assert n == len(blocks) == 3
    assert cfg_p == cfg_f
    # the peek never reads stream payloads: truncating right after the
    # header still peeks fine
    import struct

    _, cfg_len = struct.unpack_from("<BI", blob, 4)
    head = 4 + struct.calcsize("<BI") + cfg_len + 4
    assert peek_corpus_header(blob[:head]) == (cfg_p, n)


def test_v1_container_backward_compat(mld1):
    """A version-1 container (no decode_mode/rep_bits keys in the header
    JSON) still decodes — missing keys default to the v1 'ordered'
    behavior (docs/FORMAT.md version history)."""
    import dataclasses
    import json
    import struct

    from hsc_tpu import MultilevelDictionary, SignalGenerator
    from hsc_tpu.io import unpack_corpus
    from hsc_tpu.runtime import CorpusEncoder

    # reference decode in ordered mode (v1 semantics) — the default config
    # resolves decode_mode to 'integer' nowadays, which is exactly what a
    # v1 container must NOT be reinterpreted as
    mld_o = MultilevelDictionary(
        dataclasses.replace(mld1.config, decode_mode="ordered"), mld1.dicts
    )
    enc = CorpusEncoder(mld_o, backend="jax", batch_size=2)
    xs = SignalGenerator(mld1, rates=4e-3).generate_signals(
        2, mld1.config.block_size, seed=43
    )
    blob = enc.encode(xs)
    ref = enc.decode(blob)

    # rewrite the header as a v1 container: version byte 1, config JSON
    # without the v2 keys
    _, cfg_len = struct.unpack_from("<BI", blob, 4)
    head_end = 4 + struct.calcsize("<BI")
    cfg_d = json.loads(blob[head_end : head_end + cfg_len])
    cfg_d.pop("decode_mode", None)
    cfg_d.pop("rep_bits", None)
    cfg1_json = json.dumps(cfg_d).encode()
    v1 = (
        blob[:4]
        + struct.pack("<BI", 1, len(cfg1_json))
        + cfg1_json
        + blob[head_end + cfg_len :]
    )
    cfg_v1, blocks = unpack_corpus(v1)
    assert cfg_v1.decode_mode == "ordered"
    out = enc.decode(v1)
    assert out.tobytes() == ref.tobytes()


def test_out_of_range_fields_rejected():
    """Positions/atoms past the config geometry parse bit-wise but must be
    rejected at unpack time — the decoders write at position-derived
    offsets, so range errors cannot be allowed downstream."""
    import pytest

    from hsc_tpu import make_test_config
    from hsc_tpu.io.bitstream import pack_stream, unpack_stream
    from hsc_tpu.oracle.mp import LevelStream

    for entropy in ("fixed", "rice"):
        cfg = make_test_config(counts=(13,), scales=(16,), entropy=entropy)
        npos = cfg.num_positions(0)
        assert (1 << cfg.pos_bits(0)) > npos  # a too-large position encodes
        bad_pos = LevelStream(
            positions=np.array([npos], np.int32),
            atoms=np.array([0], np.int32),
            codes=np.array([5], np.int32),
            scale=np.float32(1.0), energy0=0.0, energy_res=0.0,
        )
        blob = pack_stream(cfg, 0, bad_pos)
        with pytest.raises(ValueError, match="corrupt stream"):
            unpack_stream(cfg, blob, 0)

        ka = cfg.counts_with_singletons[0]
        assert (1 << cfg.atom_bits(0)) > ka  # a too-large atom encodes
        bad_atom = LevelStream(
            positions=np.array([0], np.int32),
            atoms=np.array([ka], np.int32),
            codes=np.array([5], np.int32),
            scale=np.float32(1.0), energy0=0.0, energy_res=0.0,
        )
        blob = pack_stream(cfg, 0, bad_atom)
        with pytest.raises(ValueError, match="corrupt stream"):
            unpack_stream(cfg, blob, 0)

        # a raw all-ones amplitude field decodes to amp_maxcode + 1 — one
        # beyond anything the encoder emits; symmetric with the other checks
        bad_code = LevelStream(
            positions=np.array([0], np.int32),
            atoms=np.array([0], np.int32),
            codes=np.array([cfg.amp_maxcode + 1], np.int32),
            scale=np.float32(1.0), energy0=0.0, energy_res=0.0,
        )
        blob = pack_stream(cfg, 0, bad_code)
        with pytest.raises(ValueError, match="corrupt stream"):
            unpack_stream(cfg, blob, 0)


def test_truncated_and_corrupt_containers_fail_cleanly(mld1):
    """Decoder hardening: truncations raise clean errors and random bit
    flips either decode (into garbage) or raise — never hang or crash the
    process."""
    import dataclasses

    import numpy as np
    import pytest

    from hsc_tpu import SignalGenerator
    from hsc_tpu.io import unpack_corpus
    from hsc_tpu.runtime import CorpusEncoder

    for entropy in ("fixed", "rice"):
        cfg = dataclasses.replace(mld1.config, entropy=entropy)
        mld = type(mld1)(cfg, [d.copy() for d in mld1.dicts])
        xs = SignalGenerator(mld, rates=4e-3).generate_signals(
            2, cfg.block_size, seed=41
        )
        enc = CorpusEncoder(mld, backend="jax", batch_size=2)
        blob = enc.encode(xs)
        # truncations at every region boundary and a few interior points
        for cut in (0, 3, 5, 9, len(blob) // 2, len(blob) - 1):
            with pytest.raises((ValueError, Exception)):
                out = unpack_corpus(blob[:cut])
                # if parsing alone survived, the streams must be malformed
                raise ValueError("truncated container parsed cleanly")
        # random single-byte corruptions
        rng = np.random.default_rng(7)
        for _ in range(20):
            i = int(rng.integers(4, len(blob)))
            bad = bytearray(blob)
            bad[i] ^= 1 << int(rng.integers(8))
            try:
                cfg2, blocks = unpack_corpus(bytes(bad))
                for streams in blocks:
                    for level, s in streams:
                        assert s.positions.shape[0] == s.codes.shape[0]
            except Exception:
                pass  # clean failure is acceptable; hangs/crashes are not
