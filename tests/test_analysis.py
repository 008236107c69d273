"""Rate accounting tests (reference `tests/test_analysis.py` — SURVEY.md §2
C9): exact agreement with the serialized format, monotone rate-distortion."""

import numpy as np

from hsc_tpu.analysis import (
    bits_for_dtype,
    corpus_rates,
    multilevel_information_rates,
    rate_distortion_curve,
    stream_rate,
    visualize_rate_distortion,
)
from hsc_tpu.io import pack_corpus
from hsc_tpu.oracle import hierarchical_encode, mp_encode


def test_bits_for_dtype():
    assert bits_for_dtype(np.float32) == 32
    assert bits_for_dtype(np.float64) == 64
    assert bits_for_dtype(np.int16) == 16


def test_stream_rate_matches_serialized_size(mld1, signal1):
    cfg = mld1.config
    stream = mp_encode(
        signal1[:, None], mld1.augmented(0), mld1.gram(0), num_coefs=cfg.num_coefs[0]
    )
    r = stream_rate(cfg, 0, stream)
    assert r.n_events == stream.positions.shape[0]
    assert r.bits_per_event == cfg.event_bits(0)
    # exact: accounting equals bytes actually serialized
    from hsc_tpu.io.bitstream import pack_stream

    assert r.total_bytes == len(pack_stream(cfg, 0, stream))
    assert r.snr_db > 0


def test_corpus_rates(mld1, signal1):
    cfg = mld1.config
    stream = mp_encode(
        signal1[:, None], mld1.augmented(0), mld1.gram(0), num_coefs=cfg.num_coefs[0]
    )
    blocks = [[(0, stream)], [(0, stream)]]
    agg = corpus_rates(cfg, blocks)
    blob = pack_corpus(cfg, blocks)
    # aggregate bytes = serialized bytes minus container header/overheads
    overhead = len(blob) - agg["total_bytes"]
    assert 0 < overhead < 256
    assert agg["total_events"] == 2 * stream.positions.shape[0]
    assert agg["compression_ratio"] > 1.0


def test_multilevel_rates(mld2, signal2):
    streams = hierarchical_encode(signal2, mld2)
    reports = multilevel_information_rates(mld2.config, streams)
    assert [r.level for r in reports] == [0, 1]
    # level-1 events are cheaper per sample than raw float32
    assert reports[1].bits_per_sample < 32


def test_rate_distortion_monotone(mld1):
    from hsc_tpu import SignalGenerator

    gen = SignalGenerator(mld1, rates=4e-3)
    xs = gen.generate_signals(2, mld1.config.block_size, seed=77)
    curve = rate_distortion_curve(mld1, xs, [8, 32, 64])
    rates = [p[0] for p in curve]
    snrs = [p[1] for p in curve]
    assert rates == sorted(rates)
    assert snrs == sorted(snrs)  # more coefficients -> better SNR


def test_visualize_smoke(tmp_path, mld1):
    fig = visualize_rate_distortion(
        {"flat": [(0.5, 5.0), (1.0, 10.0)]}, path=str(tmp_path / "rd.png")
    )
    assert (tmp_path / "rd.png").exists()


def test_hierarchical_rate_distortion(mld2):
    from hsc_tpu import SignalGenerator
    from hsc_tpu.analysis import hierarchical_rate_distortion_curve

    gen = SignalGenerator(mld2, rates=[np.full(12, 4e-3), np.full(8, 1e-3)])
    xs = gen.generate_signals(2, mld2.config.block_size, seed=88)
    curve = hierarchical_rate_distortion_curve(mld2, xs, [8, 24, 48])
    rates = [p[0] for p in curve]
    assert rates == sorted(rates)
    assert all(np.isfinite(s) for _, s in curve)


def test_rate_distortion_device_matches_oracle(mld1):
    """use_device=True: one batched encode at max budget + prefix
    truncation (greedy prefix property) — rates identical to the per-budget
    oracle sweep, SNR within float tolerance of the encoder-tracked one."""
    from hsc_tpu import SignalGenerator

    gen = SignalGenerator(mld1, rates=4e-3)
    xs = gen.generate_signals(2, mld1.config.block_size, seed=78)
    budgets = [8, 32, 64]
    oracle = rate_distortion_curve(mld1, xs, budgets, use_device=False)
    device = rate_distortion_curve(mld1, xs, budgets, use_device=True)
    for (ro, so), (rd, sd) in zip(oracle, device):
        assert ro == rd  # identical event counts (prefix property)
        assert abs(so - sd) < 0.15  # decode-residual vs tracked-residual SNR


def test_level_diagnostics(tmp_path, mld2, signal2):
    """Per-level energy/coefficient diagnostics (reference
    `hsc/analysis.py :: visualize*` breadth):
    energies positive with fractions summing to 1, distribution stats match
    the streams, figure renders."""
    from hsc_tpu.analysis import (
        coefficient_distribution,
        level_energies,
        visualize_level_diagnostics,
    )

    streams = hierarchical_encode(signal2, mld2)
    blocks = [[(level, s) for level, s in enumerate(streams)]]
    en = level_energies(mld2, blocks)
    assert set(en) == {0, 1}
    assert all(v["energy"] > 0 for v in en.values())
    assert abs(sum(v["fraction"] for v in en.values()) - 1.0) < 1e-9

    dist = coefficient_distribution(mld2.config, blocks)
    for level, s in enumerate(streams):
        assert dist[level]["events"] == s.positions.shape[0]
        assert sum(dist[level]["atom_usage"]) == s.positions.shape[0]
        assert len(dist[level]["atom_usage"]) == (
            mld2.config.counts_with_singletons[level]
        )
        if s.positions.shape[0]:
            assert dist[level]["codes_abs_mean"] > 0

    visualize_level_diagnostics(
        mld2, blocks, path=str(tmp_path / "diag.png")
    )
    assert (tmp_path / "diag.png").exists()


def test_level_diagnostics_distributed_view(mld2, signal2):
    """distributed=True demotes singleton-chain events in a top-level-only
    container to their native level — the per-level views must match the
    explicit `to_distributed` split, and be idempotent on already-
    distributed pairs."""
    from hsc_tpu.analysis import coefficient_distribution, level_energies
    from hsc_tpu.oracle.mp import to_distributed, to_top_level

    cfg = mld2.config
    streams = hierarchical_encode(signal2, mld2)
    top = to_top_level(cfg, list(enumerate(streams)))
    top_blocks = [[(cfg.num_levels - 1, top)]]

    plain = level_energies(mld2, top_blocks)
    dist = level_energies(mld2, top_blocks, distributed=True)
    split = to_distributed(cfg, top)
    assert set(dist) == {lv for lv, _ in split}
    for lv, s in split:
        assert dist[lv]["events"] == s.positions.shape[0]
    # demotion preserves each event's decoded contribution, so the summed
    # per-level reconstruction equals the top-level-only reconstruction
    # (per-GROUP energies are NOT additive — within-level cross terms move
    # between groups — so compare signals, not the energy totals)
    import numpy as np

    from hsc_tpu.oracle import mp_decode

    top_rec = mp_decode(
        top, mld2.representations(cfg.num_levels - 1)[:, :, None],
        cfg.block_size,
    )
    split_rec = sum(
        mp_decode(s, mld2.representations(lv)[:, :, None], cfg.block_size)
        for lv, s in split
    )
    np.testing.assert_allclose(split_rec, top_rec, rtol=0, atol=1e-5)
    assert plain[cfg.num_levels - 1]["events"] == sum(
        v["events"] for v in dist.values()
    )

    # idempotent on distributed input: every split stream's atoms are raw
    cd_a = coefficient_distribution(cfg, [split])
    cd_b = coefficient_distribution(cfg, [split], distributed=True)
    assert cd_a == cd_b


def test_decode_mode_fidelity(mld2, signal2):
    """The decode-mode decision table: same stream bytes, ordered row first,
    integer rows monotone-ish in rep_bits, and the known result that the
    SNR cost at rep_bits=12 is negligible (docs/DESIGN.md
    'Rate-distortion notes')."""
    from hsc_tpu.analysis import decode_mode_fidelity

    xs = signal2[None, :]
    rows = decode_mode_fidelity(mld2, xs, rep_bits_list=(6, 12))
    assert rows[0]["mode"] == "ordered"
    ints = [r for r in rows if r["mode"] == "integer"]
    assert [r["rep_bits"] for r in ints] == [6, 12]
    # integer recon converges toward the ordered recon as rep_bits grows
    assert ints[1]["vs_ordered_db"] > ints[0]["vs_ordered_db"]
    # the headline claim the default decision rests on
    assert abs(ints[1]["delta_db"]) < 0.01
    # rate is untouched by decode_mode: same events either way (sanity via
    # vs_ordered being finite — both decoders consumed the same streams)
    assert np.isfinite(ints[0]["vs_ordered_db"])
