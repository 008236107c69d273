"""End-to-end experiment driver — reference parity for `scripts/*.py`
(SURVEY.md §2 C11): generate a ground-truth multilevel dictionary, synthesize
a corpus, learn dictionaries from scratch, encode at a sparsity sweep, run
the rate/distortion analysis, and emit figures.

Examples:
  python scripts/run_experiment.py --outdir /tmp/exp --blocks 8
  python scripts/run_experiment.py --outdir /tmp/exp --levels 2 \
      --counts 16,8 --scales 16,48 --block-size 2048 --backend jax
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
    p.add_argument(
        "--platform",
        default=None,
        choices=["cpu", "gpu"],
        help="force the jax platform (cpu for small local experiments)",
    )
    p.add_argument("--counts", default="16,8", help="atoms per level")
    p.add_argument("--scales", default="16,48", help="signal-space atom sizes")
    p.add_argument("--num-coefs", default="96,48")
    p.add_argument("--block-size", type=int, default=1024)
    p.add_argument("--blocks", type=int, default=8)
    p.add_argument("--rate", type=float, default=4e-3, help="event rate/sample")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--backend", default="auto", choices=["auto", "jax"])
    p.add_argument("--learn-iterations", type=int, default=10)
    p.add_argument("--budget-sweep", default="8,16,32,64")
    p.add_argument("--profile-dir", default=None)
    p.add_argument("--skip-learning", action="store_true")
    p.add_argument("--entropy", choices=["fixed", "rice"], default="fixed")
    p.add_argument("--decode-mode", choices=["ordered", "integer"],
                   default="ordered")
    p.add_argument("--num-select", type=int, default=1)
    return p.parse_args()


def main():
    args = parse_args()
    if args.platform:
        import jax

        jax.config.update(
            "jax_platforms", "cuda" if args.platform == "gpu" else "cpu"
        )

    from hsc_tpu import CodecConfig, MultilevelDictionary, SignalGenerator
    from hsc_tpu.analysis import (
        corpus_rates,
        hierarchical_rate_distortion_curve,
        rate_distortion_curve,
        visualize_rate_distortion,
    )
    from hsc_tpu.io import unpack_corpus
    from hsc_tpu.learn import MultilevelTrainer
    from hsc_tpu.runtime import CorpusEncoder
    from hsc_tpu.utils import snr_db
    from hsc_tpu.utils.cache import enable_compilation_cache
    from hsc_tpu.utils.profiling import profile_region

    enable_compilation_cache()

    os.makedirs(args.outdir, exist_ok=True)
    counts = tuple(int(x) for x in args.counts.split(","))
    scales = tuple(int(x) for x in args.scales.split(","))
    num_coefs = tuple(int(x) for x in args.num_coefs.split(","))
    cfg = CodecConfig(
        counts=counts, scales=scales, num_coefs=num_coefs,
        block_size=args.block_size, entropy=args.entropy,
        decode_mode=args.decode_mode, num_select=args.num_select,
    )
    report: dict = {"config": json.loads(cfg.to_json())}

    # 1. ground-truth dictionary + corpus (reference §3.1-3.2)
    t0 = time.time()
    truth = MultilevelDictionary.generate(cfg, seed=args.seed)
    truth.save(os.path.join(args.outdir, "truth_dict.npz"))
    truth.visualize(os.path.join(args.outdir, "truth"))
    gen = SignalGenerator(truth, rates=args.rate)
    corpus = gen.generate_signals(args.blocks, cfg.block_size, seed=args.seed + 1)
    report["corpus"] = {"blocks": args.blocks, "seconds": time.time() - t0}
    print(f"[1/5] corpus: {args.blocks} x {cfg.block_size} samples", flush=True)

    # 2. learn dictionaries from scratch (reference §3.5)
    if args.skip_learning:
        learned = truth
    else:
        t0 = time.time()
        trainer = MultilevelTrainer(
            cfg,
            iterations=args.learn_iterations,
            num_windows=min(4096, 16 * args.blocks * cfg.block_size // cfg.scales[0]),
            seed=args.seed,
            checkpoint_dir=os.path.join(args.outdir, "ckpt"),
        )
        learned = trainer.train(corpus)
        learned.save(os.path.join(args.outdir, "learned_dict.npz"))
        learned.visualize(os.path.join(args.outdir, "learned"))
        report["learning"] = {"seconds": time.time() - t0}
        print(f"[2/5] learned dictionaries in {time.time()-t0:.1f}s", flush=True)

    # 3. encode the corpus with the learned dictionary (configs 2-3)
    t0 = time.time()
    encoder = CorpusEncoder(
        learned,
        backend=args.backend,
        journal_dir=os.path.join(args.outdir, "journal"),
        metrics_path=os.path.join(args.outdir, "metrics.jsonl"),
    )
    with profile_region(args.profile_dir):
        blob = encoder.encode(corpus)
    with open(os.path.join(args.outdir, "corpus.hsct"), "wb") as f:
        f.write(blob)
    decoded = encoder.decode(blob)
    snrs = [snr_db(corpus[b], decoded[b]) for b in range(args.blocks)]
    _, stream_blocks = unpack_corpus(blob)
    rates = corpus_rates(cfg, stream_blocks)
    report["encode"] = {
        "seconds": time.time() - t0,
        "compressed_bytes": len(blob),
        "bits_per_sample": rates["bits_per_sample"],
        "compression_ratio": rates["compression_ratio"],
        "mean_snr_db": float(np.mean(snrs)),
    }
    print(
        f"[3/5] encode+decode: {rates['bits_per_sample']:.3f} bits/sample, "
        f"mean SNR {np.mean(snrs):.2f} dB",
        flush=True,
    )

    # 4. rate-distortion sweep, flat vs hierarchical (reference C9 headline)
    budgets = [int(x) for x in args.budget_sweep.split(",")]
    flat = rate_distortion_curve(learned.up_to_level(0), corpus, budgets)
    curves = {"flat (level 0)": flat}
    report["rate_distortion"] = {"flat": flat}
    if cfg.num_levels > 1:
        hier = hierarchical_rate_distortion_curve(learned, corpus, budgets)
        curves[f"hierarchical ({cfg.num_levels} levels)"] = hier
        report["rate_distortion"]["hierarchical"] = hier
    print(f"[4/5] rate-distortion sweep at budgets {budgets}", flush=True)

    # 5. figures + report
    from hsc_tpu.analysis import (
        coefficient_distribution,
        level_energies,
        visualize_level_diagnostics,
    )

    visualize_rate_distortion(
        curves, path=os.path.join(args.outdir, "rate_distortion.png")
    )
    # distributed=True: the container stores top-level-only streams, so the
    # per-level views demote singleton-chain events to their native level
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
    report["coefficient_distribution"] = {
        str(l): v
        for l, v in coefficient_distribution(
            cfg, stream_blocks, distributed=True
        ).items()
    }
    with open(os.path.join(args.outdir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(f"[5/5] wrote {args.outdir}/report.json", flush=True)


if __name__ == "__main__":
    main()
