"""Runtime pipeline: journal resume, metrics, container round-trip
(SURVEY.md §5 failure-recovery + metrics — net-new vs reference)."""

import numpy as np
import pytest

from hsc_tpu import SignalGenerator
from hsc_tpu.io import unpack_corpus
from hsc_tpu.io.journal import EncodeJournal
from hsc_tpu.runtime import CorpusEncoder
from hsc_tpu.utils.metrics import MetricsLogger, read_metrics
from hsc_tpu.utils import snr_db


def test_journal_roundtrip(tmp_path):
    j = EncodeJournal(str(tmp_path))
    j.record(0, b"block-zero")
    j.record(2, b"block-two")
    assert j.done_blocks == {0, 2}
    assert j.read(0) == b"block-zero"
    j.record(0, b"SHOULD BE IGNORED")  # idempotent
    assert j.read(0) == b"block-zero"
    with pytest.raises(ValueError):
        j.assemble(3)  # block 1 missing
    j.record(1, b"one")
    assert j.assemble(3) == [b"block-zero", b"one", b"block-two"]
    j.close()

    # reopen: state survives
    j2 = EncodeJournal(str(tmp_path))
    assert j2.done_blocks == {0, 1, 2}
    assert j2.read(2) == b"block-two"
    j2.close()


def test_journal_ignores_torn_tail(tmp_path):
    j = EncodeJournal(str(tmp_path))
    j.record(0, b"ok")
    j.close()
    with open(str(tmp_path / "corpus.journal"), "a") as f:
        f.write("1 999")  # torn line
    j2 = EncodeJournal(str(tmp_path))
    assert j2.done_blocks == {0}
    j2.close()


def test_journal_ignores_torn_tail_with_truncated_crc(tmp_path):
    """A torn final line whose truncated CRC still parses as an int must be
    dropped (no trailing newline == incomplete), not indexed with a wrong
    CRC — that would wedge resume with an IOError on every read."""
    j = EncodeJournal(str(tmp_path))
    j.record(0, b"payload-zero")
    j.record(1, b"payload-one")
    j.close()
    jp = str(tmp_path / "corpus.journal")
    with open(jp) as f:
        lines = f.read().splitlines()
    # truncate the last line's CRC by two digits and drop its newline
    with open(jp, "w") as f:
        f.write(lines[0] + "\n" + lines[1][:-2])
    j2 = EncodeJournal(str(tmp_path))
    assert j2.done_blocks == {0}  # block 1 re-encodes instead of wedging
    assert j2.read(0) == b"payload-zero"
    j2.record(1, b"payload-one")  # resume completes
    assert j2.read(1) == b"payload-one"
    j2.close()


def test_journal_config_fingerprint(tmp_path):
    """Resuming a journal under a different codec config must be refused —
    mixed-config payloads would assemble a silently corrupt container."""
    j = EncodeJournal(str(tmp_path), config_json='{"entropy":"fixed"}')
    j.record(0, b"ok")
    j.close()
    # same config resumes fine
    j2 = EncodeJournal(str(tmp_path), config_json='{"entropy":"fixed"}')
    assert j2.done_blocks == {0}
    j2.close()
    with pytest.raises(ValueError, match="different codec config"):
        EncodeJournal(str(tmp_path), config_json='{"entropy":"rice"}')
    # legacy journals without a fingerprint still open
    (tmp_path / "corpus.config").unlink()
    j3 = EncodeJournal(str(tmp_path), config_json='{"entropy":"rice"}')
    assert j3.done_blocks == {0}
    j3.close()


def test_corpus_encoder_empty_corpus_roundtrip(mld1):
    """A zero-block container encodes and decodes to an empty [0, N] array."""
    enc = CorpusEncoder(mld1, backend="jax")
    blob = enc.encode(np.zeros((0, mld1.config.block_size), np.float32))
    out = enc.decode(blob)
    assert out.shape == (0, mld1.config.block_size)
    assert out.dtype == np.float32


def test_corpus_decode_stream_matches_decode(mld1):
    """The streaming decoder yields decode()'s rows byte for byte, in
    container order, for both the common shape and a tiny batch size that
    forces multiple in-flight chunks."""
    gen = SignalGenerator(mld1, rates=4e-3)
    xs = gen.generate_signals(9, mld1.config.block_size, seed=77)
    enc = CorpusEncoder(mld1, backend="jax", batch_size=2)
    blob = enc.encode(xs)
    full = enc.decode(blob)
    rows = list(enc.decode_stream(blob))
    assert len(rows) == 9
    for b in range(9):
        assert rows[b].tobytes() == full[b].tobytes()


def test_decode_stream_distributed_container(mld2):
    """The streaming decoder serves distributed containers with bounded
    memory (chunked per-level device decodes), byte-identical
    to decode() — exercised with a batch size that forces several chunks and
    in-flight pipelining across chunk boundaries."""
    gen = SignalGenerator(mld2, rates=2e-2)
    xs = gen.generate_signals(7, mld2.config.block_size, seed=79)
    enc = CorpusEncoder(mld2, backend="jax", batch_size=2, distributed=True)
    blob = enc.encode(xs)
    full = enc.decode(blob)
    rows = list(enc.decode_stream(blob))
    assert len(rows) == 7
    for b in range(7):
        assert rows[b].tobytes() == full[b].tobytes()


def test_decode_mixed_container(mld2):
    """A container mixing top-only and distributed blocks (legal per
    FORMAT.md — e.g. journals assembled across encoder configurations)
    decodes via the chunked per-level path, and decode_stream yields the
    same bytes in container order."""
    from hsc_tpu.io.bitstream import pack_corpus
    from hsc_tpu.oracle.mp import to_distributed

    gen = SignalGenerator(mld2, rates=2e-2)
    xs = gen.generate_signals(5, mld2.config.block_size, seed=91)
    enc = CorpusEncoder(mld2, backend="jax", batch_size=2)
    top = mld2.config.num_levels - 1
    tops = [enc.coder.encode(x)[top] for x in xs]
    blocks = []
    for b, s in enumerate(tops):
        if b % 2 == 0:
            blocks.append([(top, s)])
        else:
            blocks.append(to_distributed(mld2.config, s))
    blob = pack_corpus(mld2.config, blocks)
    out = enc.decode(blob)
    # expected: per-block sum of per-stream reconstructions, container order
    for b, streams in enumerate(blocks):
        exp = np.zeros(mld2.config.block_size, np.float32)
        for lv, s in streams:
            exp += enc.coder.reconstruct(s, level=lv)
        assert out[b].tobytes() == exp.tobytes()
    rows = list(enc.decode_stream(blob))
    assert len(rows) == 5
    for b in range(5):
        assert rows[b].tobytes() == out[b].tobytes()


def test_decode_stream_distributed_bounded_memory(mld2):
    """The distributed streaming path never materializes the corpus: at most
    batch_size blocks of output exist per yielded chunk, and at most 4
    device work units are in flight (asserted by patching the device decode
    to count live outputs)."""
    gen = SignalGenerator(mld2, rates=2e-2)
    xs = gen.generate_signals(8, mld2.config.block_size, seed=83)
    enc = CorpusEncoder(mld2, backend="jax", batch_size=2, distributed=True)
    blob = enc.encode(xs)
    full = enc.decode(blob)

    calls = {"live": 0, "max_live": 0, "n": 0}
    real = enc.coder.reconstruct_batch_device

    def counting(streams, **kw):
        calls["n"] += 1
        calls["live"] += 1
        calls["max_live"] = max(calls["max_live"], calls["live"])
        assert len(streams) <= enc.batch_size
        return _Tracked(real(streams, **kw), calls)

    class _Tracked:
        def __init__(self, dev, counts):
            self._dev = dev
            self._counts = counts
            self._fetched = False

        def copy_to_host_async(self):
            pass

        def __array__(self, dtype=None):
            if not self._fetched:
                self._fetched = True
                self._counts["live"] -= 1
            a = np.asarray(self._dev)
            return a if dtype is None else a.astype(dtype)

    enc.coder.reconstruct_batch_device = counting
    try:
        rows = list(enc.decode_stream(blob))
    finally:
        enc.coder.reconstruct_batch_device = real
    assert calls["n"] >= 4  # several chunks x levels actually dispatched
    assert calls["max_live"] <= 4  # the sliding-pipeline bound
    assert len(rows) == 8
    for b in range(8):
        assert rows[b].tobytes() == full[b].tobytes()


def test_corpus_encoder_rejects_wrong_block_size(mld1):
    enc = CorpusEncoder(mld1, backend="jax")
    bad = np.zeros((2, mld1.config.block_size + 1), np.float32)
    with pytest.raises(ValueError, match="blocks must be"):
        enc.encode(bad)


def test_corpus_encoder_journal_config_guard(tmp_path, mld1):
    """CorpusEncoder wires its config into the journal fingerprint."""
    import dataclasses

    enc = CorpusEncoder(mld1, backend="jax", journal_dir=str(tmp_path / "j"))
    enc.encode(np.zeros((1, mld1.config.block_size), np.float32))
    cfg2 = dataclasses.replace(mld1.config, entropy="rice")
    mld2 = type(mld1)(cfg2, [d.copy() for d in mld1.dicts])
    with pytest.raises(ValueError, match="different codec config"):
        CorpusEncoder(mld2, backend="jax", journal_dir=str(tmp_path / "j"))


def test_metrics_logger(tmp_path):
    p = str(tmp_path / "m.jsonl")
    m = MetricsLogger(p)
    m.log({"kind": "x", "v": 1})
    m.log({"kind": "y", "v": 2})
    m.close()
    rows = read_metrics(p)
    assert [r["kind"] for r in rows] == ["x", "y"]
    assert all("ts" in r for r in rows)
    # nonzero process writes nothing
    m2 = MetricsLogger(str(tmp_path / "m2.jsonl"), process_index=1)
    m2.log({"kind": "z"})
    m2.close()
    assert not (tmp_path / "m2.jsonl").exists()


def test_corpus_encoder_roundtrip_and_resume(tmp_path, mld1):
    gen = SignalGenerator(mld1, rates=4e-3)
    xs = gen.generate_signals(6, mld1.config.block_size, seed=71)
    enc1 = CorpusEncoder(
        mld1,
        backend="jax",
        batch_size=4,
        journal_dir=str(tmp_path / "j"),
        metrics_path=str(tmp_path / "m.jsonl"),
    )
    blob1 = enc1.encode(xs)
    cfg, blocks = unpack_corpus(blob1)
    assert cfg == mld1.config and len(blocks) == 6
    decoded = enc1.decode(blob1)
    for b in range(6):
        assert snr_db(xs[b], decoded[b]) > 3.0

    rows = read_metrics(str(tmp_path / "m.jsonl"))
    enc_rows = [r for r in rows if r["kind"] == "encode_batch"]
    assert sum(r["blocks"] for r in enc_rows) == 6
    assert all(r["mb_per_s"] > 0 for r in rows)
    assert any(r["kind"] == "decode" for r in rows)

    # resume: fresh encoder with same journal produces identical bytes and
    # logs zero newly-encoded blocks
    enc2 = CorpusEncoder(
        mld1, backend="jax", batch_size=4, journal_dir=str(tmp_path / "j"),
        metrics_path=str(tmp_path / "m2.jsonl"),
    )
    blob2 = enc2.encode(xs)
    assert blob2 == blob1
    assert read_metrics(str(tmp_path / "m2.jsonl")) == []


def test_corpus_encoder_with_mesh_matches_local(tmp_path, mld1):
    """Mesh-sharded CorpusEncoder produces byte-identical containers."""
    import jax
    from hsc_tpu.parallel import make_mesh

    gen = SignalGenerator(mld1, rates=4e-3)
    xs = gen.generate_signals(10, mld1.config.block_size, seed=72)
    local = CorpusEncoder(mld1, backend="jax", batch_size=4)
    mesh = make_mesh({"data": 8})
    sharded = CorpusEncoder(mld1, backend="jax", batch_size=2, mesh=mesh)
    assert sharded.encode(xs) == local.encode(xs)


def test_corpus_encoder_hierarchical_mesh_matches_local(mld2):
    """Hierarchical (2-level) corpus encode under the mesh: every level's
    loop and the feature-map hand-off run sharded over 'data'; containers
    must be byte-identical to the local path."""
    import numpy as np
    from hsc_tpu.parallel import make_mesh

    gen = SignalGenerator(
        mld2, rates=[np.full(12, 4e-3), np.full(8, 1e-3)]
    )
    xs = gen.generate_signals(10, mld2.config.block_size, seed=74)
    local = CorpusEncoder(mld2, backend="jax", batch_size=4)
    mesh = make_mesh({"data": 8})
    sharded = CorpusEncoder(mld2, backend="jax", batch_size=2, mesh=mesh)
    blob_local = local.encode(xs)
    assert sharded.encode(xs) == blob_local
    decoded = local.decode(blob_local)
    assert decoded.shape == (10, mld2.config.block_size)


def test_corpus_encoder_distributed_representation(mld2):
    """--distributed containers: smaller than top-only at identical decoded
    output quality; round-trip decodes deterministically."""
    import numpy as np
    from hsc_tpu.io import unpack_corpus

    gen = SignalGenerator(
        mld2, rates=[np.full(12, 4e-3), np.full(8, 1e-3)]
    )
    xs = gen.generate_signals(4, mld2.config.block_size, seed=75)
    top = CorpusEncoder(mld2, backend="jax", batch_size=2)
    dist = CorpusEncoder(mld2, backend="jax", batch_size=2, distributed=True)
    blob_top = top.encode(xs)
    blob_dist = dist.encode(xs)
    # distributed blocks carry per-level streams whose events merge back to
    # the exact top-only event multiset
    from hsc_tpu.oracle.mp import to_top_level

    cfg_t, blocks_t = unpack_corpus(blob_top)
    cfg_d, blocks_d = unpack_corpus(blob_dist)
    assert any(len(streams) > 1 for streams in blocks_d)
    # demoted events pay the (smaller) lower-level atom_bits: payload bits
    # strictly shrink whenever any event left the top level (per-stream
    # header overhead can still dominate at toy scales)
    bits = lambda blocks: sum(
        s.positions.shape[0] * cfg_d.event_bits(level)
        for streams in blocks
        for level, s in streams
    )
    assert bits(blocks_d) < bits(blocks_t)
    for bt, bd in zip(blocks_t, blocks_d):
        (lt, st) = bt[0]
        merged = to_top_level(cfg_d, bd, level=lt)
        key = lambda s: sorted(
            zip(s.positions.tolist(), s.atoms.tolist(), s.codes.tolist())
        )
        assert key(merged) == key(st)
    # decoded quality identical (same events, reconstruction order may differ
    # by float association across levels)
    dec_top = top.decode(blob_top)
    dec_dist = dist.decode(blob_dist)
    assert np.allclose(dec_top, dec_dist, atol=1e-5)
    # decode of the same distributed container is deterministic
    assert dist.decode(blob_dist).tobytes() == dec_dist.tobytes()


def test_corpus_encoder_rice_roundtrip(mld1):
    """Runtime pipeline under rice entropy: encode -> container -> decode,
    decoded output matches the ordered-decode of the sorted streams."""
    import dataclasses

    cfg = dataclasses.replace(mld1.config, entropy="rice")
    mld = type(mld1)(cfg, [d.copy() for d in mld1.dicts])
    gen = SignalGenerator(mld, rates=4e-3)
    xs = gen.generate_signals(4, cfg.block_size, seed=73)
    enc = CorpusEncoder(mld, backend="jax", batch_size=2)
    blob = enc.encode(xs)
    fixed_blob = CorpusEncoder(mld1, backend="jax", batch_size=2).encode(xs)
    assert len(blob) < len(fixed_blob)  # rice streams are smaller
    decoded = enc.decode(blob)
    for b in range(4):
        assert snr_db(xs[b], decoded[b]) > 3.0


def test_multihost_split_ragged():
    from hsc_tpu.parallel.dp import DataParallelEncoder

    assert DataParallelEncoder.multihost_split(10, 4) == [
        (0, 3), (3, 6), (6, 9), (9, 10),
    ]
    assert DataParallelEncoder.multihost_split(8, 4) == [
        (0, 2), (2, 4), (4, 6), (6, 8),
    ]


def test_multihost_shard_assembly(tmp_path, mld1):
    """Faked 2-process multi-host protocol: each process
    encodes + journals its shard under global ids; process-0 assembly is
    byte-identical to the single-process container, including a ragged
    split."""
    from hsc_tpu.runtime import assemble_container

    gen = SignalGenerator(mld1, rates=4e-3)
    n_global = 7  # ragged: ceil(7/2)=4 -> p0 owns [0,4), p1 owns [4,7)
    xs = gen.generate_signals(n_global, mld1.config.block_size, seed=77)
    ref = CorpusEncoder(mld1, backend="jax", batch_size=4).encode(xs)

    jdir = str(tmp_path / "mh")
    p0 = CorpusEncoder(
        mld1, backend="jax", batch_size=4, journal_dir=jdir, process_index=0
    )
    p1 = CorpusEncoder(
        mld1, backend="jax", batch_size=4, journal_dir=jdir, process_index=1
    )
    # order scrambled on purpose: p1 finishes first
    out1 = p1.encode_multihost(xs[4:7], n_global, n_processes=2)
    assert out1 is None  # only process 0 assembles
    out0 = p0.encode_multihost(xs[0:4], n_global, n_processes=2)
    assert out0 == ref

    # wrong shard size is rejected
    with pytest.raises(ValueError, match="must pass blocks"):
        p0.encode_multihost(xs[0:3], n_global, n_processes=2)

    # assembly with a missing shard reports the gap
    jdir2 = str(tmp_path / "mh2")
    p1b = CorpusEncoder(
        mld1, backend="jax", batch_size=4, journal_dir=jdir2, process_index=1
    )
    p1b.encode_shard(xs[4:7], global_start=4)
    with pytest.raises(ValueError, match="not yet encoded"):
        assemble_container(mld1.config, jdir2, n_global, 2)


def test_encode_shard_requires_journal(mld1):
    enc = CorpusEncoder(mld1, backend="jax")
    with pytest.raises(ValueError, match="journal_dir"):
        enc.encode_shard(np.zeros((1, mld1.config.block_size), np.float32))


def test_multihost_four_process_resume(tmp_path, mld1):
    """4 faked processes, one crashing mid-shard: resume completes its
    journal and assembly still emits the byte-identical container."""
    gen = SignalGenerator(mld1, rates=4e-3)
    n_global = 13  # ragged: nl=4 -> shards 4/4/4/1
    xs = gen.generate_signals(n_global, mld1.config.block_size, seed=79)
    ref = CorpusEncoder(mld1, backend="jax", batch_size=4).encode(xs)
    from hsc_tpu.parallel.dp import DataParallelEncoder
    from hsc_tpu.runtime import assemble_container

    jdir = str(tmp_path / "mh4")
    split = DataParallelEncoder.multihost_split(n_global, 4)
    assert split == [(0, 4), (4, 8), (8, 12), (12, 13)]
    # process 2 "crashes" after its first 2 blocks; others finish
    for p, (lo, hi) in enumerate(split):
        enc = CorpusEncoder(
            mld1, backend="jax", batch_size=4, journal_dir=jdir,
            process_index=p,
        )
        if p == 2:
            enc.encode_shard(xs[lo : lo + 2], global_start=lo)
        else:
            enc.encode_shard(xs[lo:hi], global_start=lo)
    with pytest.raises(ValueError, match="not yet encoded"):
        assemble_container(mld1.config, jdir, n_global, 4)
    # process 2 restarts and resumes (already-journaled blocks skipped)
    enc2 = CorpusEncoder(
        mld1, backend="jax", batch_size=4, journal_dir=jdir, process_index=2,
    )
    enc2.encode_shard(xs[8:12], global_start=8)
    out = assemble_container(mld1.config, jdir, n_global, 4)
    assert out == ref


def test_chunked_encode_shard_assembly_single_process(tmp_path, mld1):
    """The README 'large corpora' recipe: chunked encode_shard calls +
    single-process assembly equal the one-shot container byte-for-byte."""
    from hsc_tpu.runtime import assemble_container

    gen = SignalGenerator(mld1, rates=4e-3)
    xs = gen.generate_signals(9, mld1.config.block_size, seed=81)
    ref = CorpusEncoder(mld1, backend="jax", batch_size=4).encode(xs)
    jdir = str(tmp_path / "chunks")
    codec = CorpusEncoder(mld1, backend="jax", batch_size=4, journal_dir=jdir)
    for start in range(0, 9, 4):
        codec.encode_shard(xs[start : start + 4], global_start=start)
    assert assemble_container(mld1.config, jdir, 9, 1) == ref


def test_multihost_split_never_inverted():
    """Regression: a short corpus over many processes yields empty trailing
    ranges, never inverted (lo > hi) ones."""
    from hsc_tpu.parallel.dp import DataParallelEncoder

    for n_global in (1, 3, 10, 17):
        for n_proc in (1, 2, 4, 8, 16):
            split = DataParallelEncoder.multihost_split(n_global, n_proc)
            assert all(lo <= hi for lo, hi in split), (n_global, n_proc, split)
            assert split[0][0] == 0 and split[-1][1] == n_global
            assert sum(hi - lo for lo, hi in split) == n_global


def test_corpus_decoder_with_mesh_matches_local(mld1):
    """Mesh-sharded corpus DECODE (parallel.dp.DataParallelDecoder): rows
    byte-identical to the local decoder for both decode modes, with a block
    count that forces shard padding (10 blocks on an 8-way mesh)."""
    import dataclasses

    from hsc_tpu import MultilevelDictionary
    from hsc_tpu.parallel import make_mesh

    mesh = make_mesh({"data": 8})
    for mode in ("ordered", "integer"):
        cfg_m = dataclasses.replace(mld1.config, decode_mode=mode)
        mld = MultilevelDictionary(cfg_m, mld1.dicts)
        gen = SignalGenerator(mld, rates=4e-3)
        xs = gen.generate_signals(10, cfg_m.block_size, seed=73)
        local = CorpusEncoder(mld, backend="jax", batch_size=4)
        blob = local.encode(xs)
        sharded = CorpusEncoder(mld, backend="jax", batch_size=4, mesh=mesh)
        assert sharded.decode(blob).tobytes() == local.decode(blob).tobytes()
        # streaming + random access ride the same sharded device call
        rows = list(sharded.decode_stream(blob, indices=[9, 0, 5]))
        full = local.decode(blob)
        for row, b in zip(rows, [9, 0, 5]):
            assert row.tobytes() == full[b].tobytes()


def test_corpus_decoder_mesh_distributed_container(mld2):
    """Sharded decode of a distributed container (per-level batched device
    calls under the mesh), byte-identical to the local path."""
    from hsc_tpu.parallel import make_mesh

    gen = SignalGenerator(mld2, rates=2e-2)
    xs = gen.generate_signals(7, mld2.config.block_size, seed=74)
    local = CorpusEncoder(mld2, backend="jax", batch_size=2, distributed=True)
    blob = local.encode(xs)
    mesh = make_mesh({"data": 8})
    sharded = CorpusEncoder(mld2, backend="jax", batch_size=2, mesh=mesh)
    assert sharded.decode(blob).tobytes() == local.decode(blob).tobytes()


def test_corpus_encoder_target_bps(tmp_path, mld1):
    """Constant-bitrate encode (target_bps): every block's packed payload
    fits the per-block byte budget, the container still decodes (prefixes
    are valid streams), rate-vs-quality moves the right way, a generous
    budget is a byte-level no-op, and the truncated events are exactly the
    greedy prefix of the unconstrained encode."""
    from hsc_tpu.io import iter_blocks, peek_corpus_header
    from hsc_tpu.utils import snr_db

    gen = SignalGenerator(mld1, rates=4e-3)
    xs = gen.generate_signals(4, mld1.config.block_size, seed=77)

    full = CorpusEncoder(mld1, backend="jax", batch_size=2)
    blob_full = full.encode(xs)
    dec_full = full.decode(blob_full)

    target = 0.4  # bits/sample, below the unconstrained rate
    cbr = CorpusEncoder(mld1, backend="jax", batch_size=2, target_bps=target)
    blob = cbr.encode(xs)
    budget = int(target * mld1.config.block_size / 8)
    cfg, n_blocks = peek_corpus_header(blob)
    assert n_blocks == 4
    # per-block budget respected, events are greedy prefixes of the full run
    full_blocks = list(iter_blocks(blob_full))
    for b, streams in enumerate(iter_blocks(blob)):
        from hsc_tpu.io.bitstream import pack_stream

        (lvl, s), = streams
        assert 1 + len(pack_stream(cfg, lvl, s)) <= budget
        (_, fs), = full_blocks[b]
        k = s.positions.shape[0]
        assert k <= fs.positions.shape[0]
        np.testing.assert_array_equal(s.positions, fs.positions[:k])
        np.testing.assert_array_equal(s.atoms, fs.atoms[:k])
        np.testing.assert_array_equal(s.codes, fs.codes[:k])
    # decodes, with graceful quality loss vs the unconstrained encode
    dec = cbr.decode(blob)
    assert dec.shape == dec_full.shape
    snr_cbr = np.mean([snr_db(xs[b], dec[b]) for b in range(4)])
    snr_full = np.mean([snr_db(xs[b], dec_full[b]) for b in range(4)])
    assert 0 < snr_cbr < snr_full
    assert len(blob) < len(blob_full)

    # generous budget: byte-identical to the unconstrained container
    loose = CorpusEncoder(mld1, backend="jax", batch_size=2, target_bps=64.0)
    assert loose.encode(xs) == blob_full

    # journal fingerprint: a CBR journal refuses a different rate
    j = str(tmp_path / "cbr")
    CorpusEncoder(
        mld1, backend="jax", batch_size=2, target_bps=target, journal_dir=j
    ).encode(xs)
    with pytest.raises(ValueError, match="different codec config"):
        CorpusEncoder(
            mld1, backend="jax", batch_size=2, target_bps=0.8, journal_dir=j
        )

    # below the empty-stream floor -> clean error
    tiny = CorpusEncoder(mld1, backend="jax", batch_size=2, target_bps=1e-4)
    with pytest.raises(ValueError, match="floor"):
        tiny.encode(xs)


@pytest.mark.parametrize("entropy", ["fixed", "rice"])
def test_target_bps_hierarchical_distributed(mld2, entropy):
    """CBR composes with rice entropy, hierarchies, and the distributed
    representation: the budget is charged against the FULL per-block payload
    (all level streams + headers), and containers stay decodable."""
    import dataclasses

    from hsc_tpu import MultilevelDictionary
    from hsc_tpu.io import scan_block_offsets

    cfg = dataclasses.replace(mld2.config, entropy=entropy)
    mld = MultilevelDictionary(cfg, [d.copy() for d in mld2.dicts])
    gen = SignalGenerator(mld, rates=[np.full(12, 4e-3), np.full(8, 1e-3)])
    xs = gen.generate_signals(3, cfg.block_size, seed=78)
    target = 1.0
    budget = int(target * cfg.block_size / 8)
    enc = CorpusEncoder(
        mld, backend="jax", batch_size=2, distributed=True,
        target_bps=target,
    )
    blob = enc.encode(xs)
    # per-block payload (all level streams + the count byte) fits the budget
    _, offs = scan_block_offsets(blob)
    sizes = [int(b - a) for a, b in zip(offs, offs[1:])]
    assert len(sizes) == 3
    for sz in sizes:
        assert sz <= budget
    dec = enc.decode(blob)
    assert dec.shape == (3, cfg.block_size)
    assert np.isfinite(dec).all()


def test_multihost_assembly_with_target_bps(tmp_path, mld1):
    """assemble_container matches the CBR journal fingerprint (regression:
    the :cbr= suffix was built only by CorpusEncoder, so multihost CBR
    assembly rejected its own journals) and skips absent journal FILES
    without creating empties in the shared dir."""
    import os

    from hsc_tpu.runtime import _journal_name, assemble_container

    gen = SignalGenerator(mld1, rates=4e-3)
    xs = gen.generate_signals(4, mld1.config.block_size, seed=79)
    jdir = str(tmp_path / "mh")
    for p, sl in ((0, slice(0, 2)), (1, slice(2, 4))):
        enc = CorpusEncoder(
            mld1, backend="jax", batch_size=2, journal_dir=jdir,
            process_index=p, target_bps=0.5,
        )
        enc.encode_shard(xs[sl], global_start=2 * p)
    ref = CorpusEncoder(
        mld1, backend="jax", batch_size=2, target_bps=0.5
    ).encode(xs)
    out = assemble_container(
        mld1.config, jdir, 4, 2, target_bps=0.5
    )
    assert out == ref

    # absent journal file (process that never wrote): skipped, not created;
    # its blocks show up in the missing-ids error
    with pytest.raises(ValueError, match="not yet encoded"):
        assemble_container(mld1.config, jdir, 6, 3, target_bps=0.5)
    assert not os.path.exists(
        os.path.join(jdir, f"{_journal_name(2)}.journal")
    )


def _hetero_corpus(mld, nb=6, seed=81):
    """A corpus with EASY and HARD blocks (event rates 10x apart) — the
    scenario where per-block CBR strands budget on easy blocks."""
    gen_e = SignalGenerator(mld, rates=8e-4)
    gen_h = SignalGenerator(mld, rates=8e-3)
    xs_e = gen_e.generate_signals(nb // 2, mld.config.block_size, seed=seed)
    xs_h = gen_h.generate_signals(nb - nb // 2, mld.config.block_size,
                                  seed=seed + 1)
    return np.concatenate([xs_e, xs_h])


def test_corpus_rate_mode_allocation(mld1):
    """rate_mode='corpus': ONE corpus-wide budget, allocated by marginal
    SNR per byte — total block-region bytes fit the budget, every block is
    a greedy prefix of the full encode, and the corpus SNR at equal
    target_bps beats per-block CBR on a heterogeneous corpus (easy blocks
    donate spare bytes to hard ones)."""
    from hsc_tpu.io import iter_blocks, scan_block_offsets

    xs = _hetero_corpus(mld1)
    nb = xs.shape[0]
    cfg = mld1.config
    target = 0.4
    budget = int(target * cfg.block_size * nb / 8)

    full = CorpusEncoder(mld1, backend="jax", batch_size=2)
    blob_full = full.encode(xs)
    corpus = CorpusEncoder(
        mld1, backend="jax", batch_size=2, target_bps=target,
        rate_mode="corpus",
    )
    blob_c = corpus.encode(xs)
    block = CorpusEncoder(
        mld1, backend="jax", batch_size=2, target_bps=target,
        rate_mode="block",
    )
    blob_b = block.encode(xs)

    # corpus-wide budget respected on the block region
    _, offs = scan_block_offsets(blob_c)
    assert int(offs[-1] - offs[0]) <= budget
    # every emitted stream is a greedy prefix of the unconstrained encode
    full_blocks = list(iter_blocks(blob_full))
    ks = []
    for b, streams in enumerate(iter_blocks(blob_c)):
        (_, s), = streams
        (_, fs), = full_blocks[b]
        k = s.positions.shape[0]
        ks.append((k, fs.positions.shape[0]))
        np.testing.assert_array_equal(s.positions, fs.positions[:k])
        np.testing.assert_array_equal(s.codes, fs.codes[:k])
    # allocation is NON-uniform: easy blocks' late events have tiny gains
    # (MP fills the num_coefs budget regardless), so they donate events to
    # the hard half (that's the reallocation working)
    k_easy = np.mean([k for k, _ in ks[: nb // 2]])
    k_hard = np.mean([k for k, _ in ks[nb // 2 :]])
    assert k_easy < k_hard
    assert any(k < n for k, n in ks)
    # equal-rate quality: corpus allocation beats per-block CBR on CORPUS
    # SNR (total explained energy — the criterion the allocator maximizes;
    # mean per-block SNR is scale-invariant per block, so energy-optimal
    # reallocation away from near-silent blocks can lower it by design)
    dec_c = corpus.decode(blob_c)
    dec_b = block.decode(blob_b)
    snr_c = snr_db(xs.reshape(-1), dec_c.reshape(-1))
    snr_b = snr_db(xs.reshape(-1), dec_b.reshape(-1))
    assert snr_c > snr_b
    # and it actually uses the budget headroom per-block CBR strands
    assert len(blob_c) >= len(blob_b)

    # generous budget: byte-identical to the unconstrained container
    loose = CorpusEncoder(
        mld1, backend="jax", batch_size=2, target_bps=64.0,
        rate_mode="corpus",
    )
    assert loose.encode(xs) == blob_full

    # below the corpus floor -> clean error
    with pytest.raises(ValueError, match="floor"):
        CorpusEncoder(
            mld1, backend="jax", batch_size=2, target_bps=1e-4,
            rate_mode="corpus",
        ).encode(xs)


def test_corpus_rate_mode_journal_and_multihost(tmp_path, mld1):
    """Corpus-mode journals hold FULL top-form payloads (truncation at
    assembly): resume is byte-identical, a different rate is refused (the
    :cbrc= fingerprint), and multi-host shard journals assemble with the
    GLOBAL corpus allocation — byte-identical to the single-host encode."""
    from hsc_tpu.runtime import assemble_container

    xs = _hetero_corpus(mld1, nb=4, seed=91)
    cfg = mld1.config
    target = 0.4
    j = str(tmp_path / "cc")
    enc = CorpusEncoder(
        mld1, backend="jax", batch_size=2, target_bps=target,
        rate_mode="corpus", journal_dir=j,
    )
    blob = enc.encode(xs)
    # journal records are FULL streams (rate applied only at assembly)
    full = CorpusEncoder(mld1, backend="jax", batch_size=2).encode(xs)
    assert len(blob) < len(full)
    from hsc_tpu.io import iter_blocks

    for rec, streams in zip(
        (enc.journal.read(b) for b in range(4)), iter_blocks(full)
    ):
        (_, fs), = streams
        from hsc_tpu.io.bitstream import unpack_block

        (_, js), = unpack_block(cfg, rec, 0)[0]
        assert js.positions.shape[0] == fs.positions.shape[0]
    # resume: byte-identical, no recompute
    enc2 = CorpusEncoder(
        mld1, backend="jax", batch_size=2, target_bps=target,
        rate_mode="corpus", journal_dir=j,
    )
    assert enc2.encode(xs) == blob
    # another rate refuses the journal (cbrc= is part of the fingerprint)
    with pytest.raises(ValueError, match="different codec config"):
        CorpusEncoder(
            mld1, backend="jax", batch_size=2, target_bps=0.8,
            rate_mode="corpus", journal_dir=j,
        )

    # multihost: per-process shards, global allocation at assembly
    jdir = str(tmp_path / "mh")
    for p, sl in ((0, slice(0, 2)), (1, slice(2, 4))):
        CorpusEncoder(
            mld1, backend="jax", batch_size=2, journal_dir=jdir,
            process_index=p, target_bps=target, rate_mode="corpus",
        ).encode_shard(xs[sl], global_start=2 * p)
    out = assemble_container(
        cfg, jdir, 4, 2, target_bps=target, rate_mode="corpus"
    )
    assert out == blob


def test_corpus_rate_mode_distributed(mld2):
    """Corpus CBR composes with the distributed representation: journaled
    payloads stay TOP form (the greedy prefix order lives there); the
    budget is charged against the EMITTED distributed records; containers
    decode."""
    from hsc_tpu.io import iter_blocks, scan_block_offsets

    gen = SignalGenerator(mld2, rates=[np.full(12, 4e-3), np.full(8, 1e-3)])
    xs = gen.generate_signals(3, mld2.config.block_size, seed=78)
    target = 1.0
    enc = CorpusEncoder(
        mld2, backend="jax", batch_size=2, distributed=True,
        target_bps=target, rate_mode="corpus",
    )
    blob = enc.encode(xs)
    cfgb = mld2.config
    budget = int(target * cfgb.block_size * 3 / 8)
    _, offs = scan_block_offsets(blob)
    assert int(offs[-1] - offs[0]) <= budget
    # distributed emission: blocks may carry several level streams
    assert any(len(streams) > 1 for streams in iter_blocks(blob))
    dec = enc.decode(blob)
    assert dec.shape == (3, cfgb.block_size)
    assert np.isfinite(dec).all()


def test_cbr_containers_serve_everywhere(tmp_path, mld1):
    """CBR containers (both rate modes) are ordinary containers: the
    streaming decoder, seek-index random access, and the mmap CorpusReader
    all serve rows byte-identical to the full decode."""
    from hsc_tpu.runtime import CorpusReader

    xs = _hetero_corpus(mld1, nb=4, seed=95)
    for rate_mode in ("block", "corpus"):
        enc = CorpusEncoder(
            mld1, backend="jax", batch_size=2, target_bps=0.4,
            rate_mode=rate_mode,
        )
        blob = enc.encode(xs, index=True)
        full = enc.decode(blob)
        streamed = np.concatenate(
            [r[None] for r in enc.decode_stream(blob)], axis=0
        )
        assert streamed.tobytes() == full.tobytes()
        sel = enc.decode_blocks(blob, [2, 0])
        assert sel[0].tobytes() == full[2].tobytes()
        assert sel[1].tobytes() == full[0].tobytes()
        p = tmp_path / f"s_{rate_mode}.hsct"
        p.write_bytes(blob)
        rd = CorpusReader(str(p), mld1, backend="jax", batch_size=2)
        try:
            assert rd[1].tobytes() == full[1].tobytes()
            assert np.stack(list(rd.rows(1, 3))).tobytes() == (
                full[1:3].tobytes()
            )
        finally:
            rd.close()


def test_journal_fingerprint_roundtrip(mld1):
    """The one builder/parser pair for the journal resume fingerprint:
    round trip over every flag combination, and int-typed rates fingerprint
    identically to their float form (regression: an int target_bps built a
    mismatching fingerprint and assembly rejected valid journals)."""
    from hsc_tpu.runtime import (
        journal_fingerprint,
        parse_journal_fingerprint,
        parse_journal_name,
        _journal_name,
    )

    cfg = mld1.config
    for distributed in (False, True):
        for bps in (None, 0.5, 1, 1.0):
            for mode in ("block", "corpus"):
                fp = journal_fingerprint(cfg, distributed, bps, mode)
                cj, d2, t2, m2 = parse_journal_fingerprint(fp)
                assert cj == cfg.to_json()
                assert d2 == distributed
                assert t2 == (None if bps is None else float(bps))
                # mode is only observable when a rate is recorded
                assert m2 == (mode if bps is not None else "block")
    assert journal_fingerprint(cfg, True, 1) == journal_fingerprint(
        cfg, True, 1.0
    )
    # the two rate modes journal DIFFERENT payload bytes -> distinct prints
    assert journal_fingerprint(cfg, False, 0.5, "block") != (
        journal_fingerprint(cfg, False, 0.5, "corpus")
    )
    # name scheme: builder/parser adjacency
    for p in (0, 1, 7, 23):
        assert parse_journal_name(_journal_name(p)) == p
    assert parse_journal_name("corpus.pX") is None
    assert parse_journal_name("other") is None
    # suffix anchoring: ':cbr=' / ':distributed' as LITERALS inside the
    # config JSON must not be mis-split (the parse is anchored at the end;
    # config JSON always ends in '}')
    for fake_json in ('{"note":"x:cbr=2.0"}', '{"note":":distributed"}'):
        cj, d2, t2, m2 = parse_journal_fingerprint(fake_json)
        assert (cj, d2, t2, m2) == (fake_json, False, None, "block")
        cj, d2, t2, m2 = parse_journal_fingerprint(fake_json + ":cbr=1.5")
        assert (cj, d2, t2, m2) == (fake_json, False, 1.5, "block")
        cj, d2, t2, m2 = parse_journal_fingerprint(
            fake_json + ":distributed:cbr=0.25"
        )
        assert (cj, d2, t2, m2) == (fake_json, True, 0.25, "block")
        cj, d2, t2, m2 = parse_journal_fingerprint(
            fake_json + ":distributed:cbrc=0.25"
        )
        assert (cj, d2, t2, m2) == (fake_json, True, 0.25, "corpus")


def test_journal_peek_done_blocks_read_only(tmp_path):
    """`EncodeJournal.peek_done_blocks` never creates files — including the
    case of a .journal present without its .blocks companion —
    and matches the constructor's index for a healthy journal."""
    import os

    from hsc_tpu.io.journal import EncodeJournal

    jdir = str(tmp_path)
    # healthy journal: probe matches the loaded index
    j = EncodeJournal(jdir, name="corpus")
    j.record(0, b"abc")
    j.record(5, b"defg")
    j.close()
    assert EncodeJournal.peek_done_blocks(jdir, "corpus") == {0, 5}
    # orphan .journal (no .blocks): probe returns empty and creates NOTHING
    jpath = os.path.join(jdir, "corpus.p1.journal")
    with open(jpath, "w") as f:
        f.write("0 0 3 123\n")
    before = sorted(os.listdir(jdir))
    assert EncodeJournal.peek_done_blocks(jdir, "corpus.p1") == set()
    assert sorted(os.listdir(jdir)) == before
    # torn final line (no trailing newline) is ignored, earlier lines kept
    with open(os.path.join(jdir, "corpus.journal"), "ab") as f:
        f.write(b"7 0 1 99")  # torn: no newline
    assert EncodeJournal.peek_done_blocks(jdir, "corpus") == {0, 5}
