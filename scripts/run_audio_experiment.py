"""Real-audio end-to-end experiment — the reference's purpose on audio
(SURVEY.md §6; `hsc/analysis.py :: calculateMultilevelInformationRates`):
learn a multilevel dictionary FROM AUDIO, encode at a sparsity sweep, and
emit the flat-vs-hierarchical rate-distortion comparison, plus container
round-trip integrity checks and decoded WAV output.

The corpus is a WAV file (``--input``) or, since this environment has no
network, realistically synthesized music/speech
(`hsc_tpu.signal.synthesize_music` / `synthesize_speech` — harmonic
plucked-string polyphony / formant speech, both seeded).

Examples:
  python scripts/run_audio_experiment.py --outdir /tmp/audio --platform cpu
  python scripts/run_audio_experiment.py --outdir /tmp/audio --synth speech \
      --seconds 8 --platform cpu
  python scripts/run_audio_experiment.py --outdir /tmp/audio \
      --input corpus.wav --backend jax
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def parse_args():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--outdir", required=True)
    p.add_argument("--input", default=None, help="WAV corpus (else synthesized)")
    p.add_argument(
        "--synth", default="music", choices=["music", "speech", "both"],
        help="synthesized corpus kind when --input is not given",
    )
    p.add_argument("--seconds", type=float, default=16.0)
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument(
        "--platform", default=None, choices=["cpu", "gpu"],
        help="force the jax platform",
    )
    p.add_argument("--backend", default="auto", choices=["auto", "jax"])
    p.add_argument("--counts", default="32,16")
    p.add_argument("--scales", default="32,96")
    p.add_argument("--num-coefs", default="512,192")
    p.add_argument("--block-size", type=int, default=8192)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--learn-iterations", type=int, default=12)
    p.add_argument("--budget-sweep", default="16,32,64,128")
    p.add_argument("--rd-blocks", type=int, default=4,
                   help="corpus prefix used for the (oracle-run) R-D sweep")
    p.add_argument("--entropy", choices=["fixed", "rice"], default="rice")
    p.add_argument("--target-bps", type=float, default=None,
                   help="constant-bitrate mode: greedy-prefix truncation "
                   "to this bits/sample budget")
    p.add_argument("--rate-mode", choices=["block", "corpus"],
                   default="block",
                   help="--target-bps allocation: a hard per-block cap "
                   "(block) or one corpus-wide budget by marginal SNR/byte "
                   "(corpus — wins on heterogeneous corpora)")
    p.add_argument("--decode-mode", choices=["ordered", "integer"],
                   default="ordered")
    return p.parse_args()


def main():
    args = parse_args()
    if args.platform:
        import jax

        jax.config.update(
            "jax_platforms", "cuda" if args.platform == "gpu" else "cpu"
        )

    from hsc_tpu import CodecConfig
    from hsc_tpu.analysis import (
        corpus_rates,
        hierarchical_rate_distortion_curve,
        rate_distortion_curve,
        visualize_rate_distortion,
    )
    from hsc_tpu.io import unpack_corpus
    from hsc_tpu.learn import MultilevelTrainer
    from hsc_tpu.runtime import CorpusEncoder
    from hsc_tpu.signal import (
        load_wav_blocks,
        save_wav,
        synthesize_music,
        synthesize_speech,
    )
    from hsc_tpu.utils import snr_db
    from hsc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    os.makedirs(args.outdir, exist_ok=True)
    counts = tuple(int(x) for x in args.counts.split(","))
    scales = tuple(int(x) for x in args.scales.split(","))
    num_coefs = tuple(int(x) for x in args.num_coefs.split(","))
    cfg = CodecConfig(
        counts=counts, scales=scales, num_coefs=num_coefs,
        block_size=args.block_size, entropy=args.entropy,
        decode_mode=args.decode_mode,
    )
    report: dict = {"config": json.loads(cfg.to_json())}

    # 1. audio corpus ---------------------------------------------------------
    t0 = time.time()
    n = int(args.seconds * args.sample_rate)
    if args.input:
        corpus = load_wav_blocks(args.input, cfg.block_size)
        source = args.input
    else:
        parts = []
        if args.synth in ("music", "both"):
            parts.append(synthesize_music(n, args.sample_rate, seed=args.seed))
        if args.synth in ("speech", "both"):
            parts.append(
                synthesize_speech(n, args.sample_rate, seed=args.seed + 1)
            )
        x = np.concatenate(parts)
        wav_in = os.path.join(args.outdir, "corpus_in.wav")
        save_wav(wav_in, x, rate=args.sample_rate)
        corpus = load_wav_blocks(wav_in, cfg.block_size)
        source = f"synthesized:{args.synth}"
    report["corpus"] = {
        "source": source, "blocks": int(corpus.shape[0]),
        "samples": int(corpus.size), "seconds_audio": corpus.size / args.sample_rate,
        "seconds_wall": time.time() - t0,
    }
    print(f"[1/5] corpus: {corpus.shape[0]} x {cfg.block_size} samples "
          f"({source})", flush=True)

    # 2. learn the multilevel dictionary FROM the audio ----------------------
    t0 = time.time()
    trainer = MultilevelTrainer(
        cfg,
        iterations=args.learn_iterations,
        num_windows=min(8192, 8 * corpus.size // cfg.scales[0]),
        seed=args.seed,
        checkpoint_dir=os.path.join(args.outdir, "ckpt"),
    )
    learned = trainer.train(corpus)
    learned.save(os.path.join(args.outdir, "learned_dict.npz"))
    learned.visualize(os.path.join(args.outdir, "learned"))
    report["learning"] = {"seconds": time.time() - t0}
    print(f"[2/5] learned {counts} atoms from audio in {time.time()-t0:.1f}s",
          flush=True)

    # 3. encode / decode + container integrity -------------------------------
    t0 = time.time()
    encoder = CorpusEncoder(
        learned, backend=args.backend,
        metrics_path=os.path.join(args.outdir, "metrics.jsonl"),
        target_bps=args.target_bps, rate_mode=args.rate_mode,
    )
    blob = encoder.encode(corpus)
    with open(os.path.join(args.outdir, "corpus.hsct"), "wb") as f:
        f.write(blob)
    # round-trip integrity: re-encode determinism + streaming == full decode
    blob2 = encoder.encode(corpus)
    assert blob2 == blob, "re-encode must be byte-identical (determinism)"
    decoded = encoder.decode(blob)
    streamed = np.concatenate(list(encoder.decode_stream(blob)), axis=0)
    assert streamed.tobytes() == decoded.tobytes(), (
        "streaming decode must be byte-identical to full decode"
    )
    save_wav(
        os.path.join(args.outdir, "decoded.wav"),
        decoded.reshape(-1)[: corpus.size],
        rate=args.sample_rate,
    )
    snrs = [snr_db(corpus[b], decoded[b]) for b in range(corpus.shape[0])]
    _, stream_blocks = unpack_corpus(blob)
    rates = corpus_rates(cfg, stream_blocks)
    report["encode"] = {
        "seconds": time.time() - t0,
        "compressed_bytes": len(blob),
        "bits_per_sample": rates["bits_per_sample"],
        "compression_ratio": rates["compression_ratio"],
        "mean_snr_db": float(np.mean(snrs)),
        # energy-weighted corpus SNR — the criterion rate_mode='corpus'
        # CBR allocation maximizes (total explained energy at the budget)
        "corpus_snr_db": float(
            snr_db(corpus.reshape(-1), decoded.reshape(-1))
        ),
        "roundtrip_byte_identity": True,
    }
    print(
        f"[3/5] encode+decode: {rates['bits_per_sample']:.3f} bits/sample "
        f"({rates['compression_ratio']:.1f}x), mean SNR "
        f"{np.mean(snrs):.2f} dB, round-trip byte-identical",
        flush=True,
    )

    # 4. flat vs hierarchical R-D on the audio corpus ------------------------
    budgets = [int(x) for x in args.budget_sweep.split(",")]
    rd_corpus = corpus[: args.rd_blocks]
    flat = rate_distortion_curve(
        learned.up_to_level(0), rd_corpus, budgets, use_device=True
    )
    curves = {"flat (level 0)": flat}
    report["rate_distortion"] = {"flat": flat}
    if cfg.num_levels > 1:
        hier = hierarchical_rate_distortion_curve(learned, rd_corpus, budgets)
        curves[f"hierarchical ({cfg.num_levels} levels)"] = hier
        report["rate_distortion"]["hierarchical"] = hier
    # decode-mode fidelity: the SNR cost of the 20-28x-faster integer
    # decoder vs ordered mode, per rep_bits (same stream bytes — rate is
    # unchanged; see analysis.decode_mode_fidelity)
    from hsc_tpu.analysis import decode_mode_fidelity

    report["decode_mode_fidelity"] = decode_mode_fidelity(learned, rd_corpus)
    print(f"[4/5] audio R-D sweep at top budgets {budgets}; decode-mode "
          f"fidelity: {report['decode_mode_fidelity']}", flush=True)

    # 5. figures + report -----------------------------------------------------
    from hsc_tpu.analysis import level_energies, visualize_level_diagnostics

    visualize_rate_distortion(
        curves, path=os.path.join(args.outdir, "rate_distortion.png")
    )
    # distributed=True: demote singleton-chain events to their native level
    # (the container stores top-level-only streams)
    visualize_level_diagnostics(
        learned, stream_blocks,
        path=os.path.join(args.outdir, "level_diagnostics.png"),
        distributed=True,
    )
    report["level_energies"] = {
        str(l): v
        for l, v in level_energies(
            learned, stream_blocks, distributed=True
        ).items()
    }
    with open(os.path.join(args.outdir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(f"[5/5] wrote {args.outdir}/report.json", flush=True)


if __name__ == "__main__":
    main()
