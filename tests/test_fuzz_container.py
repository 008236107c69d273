"""Widened container-surface mutation fuzz.

`test_bitstream.py` covers truncations + single-bit flips on
`unpack_corpus`; this file drives SEEDED structured and multi-byte
mutations — config-JSON region, mid-stream rice payloads, seek-index
footer, journal files, CBR-truncated streams — through EVERY read
surface: `unpack_corpus`, `CorpusEncoder.decode` / `decode_blocks`
(seek-index random access), `CorpusReader` (mmap serving), and
`assemble_container`.  The contract everywhere: a clean Python exception
or a garbage-but-SHAPE-BOUNDED decode — never a hang, a native crash, or
an out-of-bounds read (numpy/mmap would surface one as a crash, so
surviving the sweep is the assertion).
"""

import dataclasses
import os

import numpy as np
import pytest

from hsc_tpu import SignalGenerator
from hsc_tpu.io import unpack_corpus
from hsc_tpu.io.bitstream import read_index
from hsc_tpu.runtime import CorpusEncoder, CorpusReader, assemble_container

N_MUTATIONS = 24  # per (entropy, surface-sweep) — seeded, CI-sized


def _mutate(rng, blob: bytes, lo: int = 4, hi: int | None = None) -> bytes:
    """One structured mutation: overwrite a random 2-64 byte run inside
    [lo, hi) with random bytes (multi-byte splices catch length/offset
    confusions single-bit flips cannot)."""
    hi = len(blob) if hi is None else hi
    if hi - lo < 2:
        return blob
    n = int(rng.integers(2, min(64, hi - lo) + 1))
    at = int(rng.integers(lo, hi - n + 1))
    bad = bytearray(blob)
    bad[at : at + n] = bytes(rng.integers(0, 256, size=n, dtype=np.uint8))
    return bytes(bad)


def _config_region(blob: bytes) -> tuple[int, int]:
    """Byte range of the config-JSON region (after MAGIC + version/len)."""
    import struct

    _, cfg_len = struct.unpack_from("<BI", blob, 4)
    start = 4 + struct.calcsize("<BI")
    return start, start + cfg_len


def _try_all_surfaces(enc, mld, blob: bytes, tmp_path, tag: str):
    """Push one (possibly corrupted) container through every read surface;
    each must raise cleanly or return shape-bounded output."""
    cfg = mld.config
    nb_true = 2
    # 1. host parse
    try:
        cfg2, blocks = unpack_corpus(blob)
        for streams in blocks:
            for level, s in streams:
                assert s.positions.shape[0] == s.codes.shape[0]
                assert s.positions.shape[0] <= 1 << 24
        parsed = True
    except Exception:
        parsed = False
    # 2. full decode (device path) — only when the host parse survived
    if parsed:
        try:
            out = enc.decode(blob)
            assert out.shape[1] == cfg.block_size
            assert out.shape[0] <= max(len(blocks), nb_true)
        except Exception:
            pass
    # 3. random access via the seek path (footer or scan)
    try:
        out = enc.decode_blocks(blob, [0])
        assert out.shape == (1, cfg.block_size)
    except Exception:
        pass
    # 4. mmap serving handle
    p = tmp_path / f"fz_{tag}.hsct"
    p.write_bytes(blob)
    try:
        reader = CorpusReader(str(p), mld, backend="jax", batch_size=2)
        try:
            if len(reader) > 0:
                row = reader[0]
                assert row.shape == (cfg.block_size,)
        finally:
            reader.close()
    except Exception:
        pass


@pytest.mark.parametrize("entropy", ["fixed", "rice"])
def test_structured_mutation_fuzz_all_surfaces(tmp_path, mld1, entropy):
    cfg = dataclasses.replace(mld1.config, entropy=entropy)
    mld = type(mld1)(cfg, [d.copy() for d in mld1.dicts])
    xs = SignalGenerator(mld, rates=4e-3).generate_signals(
        2, cfg.block_size, seed=51
    )
    enc = CorpusEncoder(mld, backend="jax", batch_size=2)
    # CBR-truncated streams ride the same sweep (prefix streams are a
    # fuzzed surface too; both rate modes produce ordinary containers)
    blob_vbr = enc.encode(xs, index=True)
    blob_cbr = CorpusEncoder(
        mld, backend="jax", batch_size=2, target_bps=0.4, rate_mode="corpus"
    ).encode(xs, index=True)
    rng = np.random.default_rng(52)
    for bi, blob in enumerate((blob_vbr, blob_cbr)):
        c0, c1 = _config_region(blob)
        regions = [
            ("config", c0, c1),             # header JSON
            ("payload", c1 + 4, len(blob) - 48),  # stream payloads
            ("footer", max(len(blob) - 48, c1), len(blob)),  # seek index
            ("anywhere", 4, len(blob)),
        ]
        for mi in range(N_MUTATIONS):
            name, lo, hi = regions[mi % len(regions)]
            bad = _mutate(rng, blob, lo, max(hi, lo + 2))
            _try_all_surfaces(enc, mld, bad, tmp_path, f"{entropy}{bi}{mi}")
        # truncations at random points (including inside the footer)
        for mi in range(8):
            cut = int(rng.integers(0, len(blob)))
            _try_all_surfaces(
                enc, mld, blob[:cut], tmp_path, f"t{entropy}{bi}{mi}"
            )


def test_semantic_config_mutations(mld1):
    """Valid-JSON-but-hostile config headers must raise ValueError from
    config validation, not crash downstream with huge allocations."""
    import json
    import struct

    xs = SignalGenerator(mld1, rates=4e-3).generate_signals(
        1, mld1.config.block_size, seed=53
    )
    enc = CorpusEncoder(mld1, backend="jax", batch_size=1)
    blob = enc.encode(xs)
    c0, c1 = _config_region(blob)
    base = json.loads(blob[c0:c1].decode())
    hostile = [
        {**base, "counts": [0]},
        {**base, "counts": []},
        {**base, "block_size": -8},
        {**base, "block_size": 0},
        {**base, "num_coefs": [-4]},
        {**base, "scales": [10 ** 9]},          # atom wider than the block
        {**base, "amp_bits": 0},
        {**base, "amp_bits": 99},
        {**base, "rep_bits": -1},
        {**base, "num_select": 0},
        {**base, "decode_mode": "nonsense"},
        {**base, "entropy": "zstd"},
        {**base, "hier_init": "float8"},
    ]
    for d in hostile:
        j = json.dumps(d).encode()
        bad = (
            blob[:4]
            + struct.pack("<BI", blob[4], len(j))
            + j
            + blob[c1:]
        )
        with pytest.raises(Exception) as ei:
            cfg2, blocks = unpack_corpus(bad)
            enc.decode(bad)
        assert isinstance(
            ei.value, (ValueError, KeyError, TypeError, AssertionError)
        ), f"unexpected {type(ei.value)} for {d}"


def test_footer_offset_mutations(tmp_path, mld1):
    """Seek-index footers with out-of-range / shuffled offsets must never
    cause an out-of-bounds read: random access raises or falls back to the
    scan, and CorpusReader stays shape-bounded."""
    xs = SignalGenerator(mld1, rates=4e-3).generate_signals(
        3, mld1.config.block_size, seed=54
    )
    enc = CorpusEncoder(mld1, backend="jax", batch_size=2)
    blob = enc.encode(xs, index=True)
    offs = read_index(blob)
    assert offs is not None and offs.shape[0] == 4
    import struct

    rng = np.random.default_rng(55)
    for trial in range(12):
        bad = bytearray(blob)
        # footer layout: trailer magic + crc'd offsets — poke the offset
        # words directly so some mutations keep the CRC region plausible
        for _ in range(int(rng.integers(1, 4))):
            at = len(blob) - int(rng.integers(8, 56))
            struct.pack_into(
                "<q", bad, at, int(rng.integers(-(1 << 40), 1 << 40))
            )
        bad = bytes(bad)
        try:
            out = enc.decode_blocks(bad, [0, 2])
            assert out.shape == (2, mld1.config.block_size)
        except Exception:
            pass
        p = tmp_path / f"foot{trial}.hsct"
        p.write_bytes(bad)
        try:
            r = CorpusReader(str(p), mld1, backend="jax", batch_size=2)
            try:
                if len(r):
                    assert r[0].shape == (mld1.config.block_size,)
            finally:
                r.close()
        except Exception:
            pass


def test_journal_file_mutations(tmp_path, mld1):
    """Corrupted journal companions: payload-bytes corruption is caught by
    the CRC at read (assemble raises, never emits silent garbage), and
    index-line corruption is dropped or rejected — never a crash, and
    never an un-flagged wrong container."""
    xs = SignalGenerator(mld1, rates=4e-3).generate_signals(
        3, mld1.config.block_size, seed=56
    )
    jdir = tmp_path / "j"
    enc = CorpusEncoder(
        mld1, backend="jax", batch_size=2, journal_dir=str(jdir)
    )
    blob = enc.encode(xs)
    jpath = jdir / "corpus.journal"
    bpath = jdir / "corpus.blocks"
    fingerprint = (jdir / "corpus.config").read_text()
    jbytes = jpath.read_bytes()
    bbytes = bpath.read_bytes()
    rng = np.random.default_rng(57)

    from hsc_tpu.io.journal import EncodeJournal

    for trial in range(10):
        # corrupt the payload file -> CRC must flag any read of a damaged
        # record; undamaged records still assemble
        bad = bytearray(bbytes)
        at = int(rng.integers(0, max(len(bad) - 4, 1)))
        bad[at : at + 4] = bytes(rng.integers(0, 256, 4, dtype=np.uint8))
        bpath.write_bytes(bytes(bad))
        j = EncodeJournal(str(jdir), config_json=fingerprint)
        try:
            for b in sorted(j.done_blocks):
                data = j.read(b)  # either intact bytes or IOError
                assert isinstance(data, bytes)
        except IOError:
            pass
        finally:
            j.close()
        # assemble_container over the damaged dir: clean error or a
        # container identical to the pristine one (mutation hit padding)
        try:
            out = assemble_container(
                mld1.config, str(jdir), 3, 1,
                fingerprint=fingerprint,
            )
            assert out == blob
        except (IOError, ValueError):
            pass
        bpath.write_bytes(bbytes)

    for trial in range(10):
        # corrupt the index file: torn/garbled lines are dropped on load
        # (missing blocks then surface as clean errors), never a crash
        bad = bytearray(jbytes)
        at = int(rng.integers(0, max(len(bad) - 6, 1)))
        bad[at : at + 6] = bytes(rng.integers(0, 256, 6, dtype=np.uint8))
        jpath.write_bytes(bytes(bad))
        try:
            j = EncodeJournal(
                str(jdir), config_json=fingerprint
            )
            try:
                for b in sorted(j.done_blocks):
                    try:
                        j.read(b)
                    except IOError:
                        pass
            finally:
                j.close()
        except (IOError, ValueError):
            pass
        jpath.write_bytes(jbytes)
    enc.journal.close()
