"""Weak-scaling harness for data-parallel encode.

Measures blocks/s at 1, 2, 4, ... shards with a constant per-shard load and
reports parallel efficiency.  The default run uses the 8-way virtual CPU
mesh — it validates the *sharding structure* (no hidden serialization or
cross-shard chatter in the encode path); absolute multi-device numbers need
`--platform gpu` on a multi-GPU host, where the same code runs unchanged
(`parallel/dp.py`, `parallel/mesh.py`).

  python scripts/bench_scaling.py            # virtual CPU mesh
  python scripts/bench_scaling.py --blocks-per-shard 4 --max-shards 8
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--blocks-per-shard", type=int, default=2)
    p.add_argument("--max-shards", type=int, default=8)
    p.add_argument("--block-size", type=int, default=4096)
    p.add_argument("--num-coefs", type=int, default=128)
    p.add_argument("--counts", type=int, default=32)
    p.add_argument("--scales", type=int, default=32)
    p.add_argument("--platform", default="cpu", choices=["cpu", "gpu"])
    p.add_argument("--hierarchical", action="store_true",
                   help="weak-scale the 2-level hierarchical DP pipeline "
                   "(sharded feature-map hand-off) instead of single-level")
    p.add_argument("--decode", action="store_true",
                   help="weak-scale the mesh-sharded DECODE "
                   "(parallel.dp.DataParallelDecoder) instead of encode")
    args = p.parse_args()

    os.environ.setdefault(
        "XLA_FLAGS",
        f"--xla_force_host_platform_device_count={args.max_shards}",
    )
    import jax

    jax.config.update("jax_platforms", "cuda" if args.platform == "gpu" else "cpu")

    from hsc_tpu import CodecConfig, MultilevelDictionary, SignalGenerator
    from hsc_tpu.models import (
        ConvolutionalSparseCoder,
        HierarchicalConvolutionalSparseCoder,
    )
    from hsc_tpu.parallel import (
        DataParallelEncoder,
        HierarchicalDataParallelEncoder,
        make_mesh,
    )

    if args.hierarchical:
        cfg = CodecConfig(
            counts=(args.counts, max(args.counts // 2, 2)),
            scales=(args.scales, 3 * args.scales),
            num_coefs=(args.num_coefs, max(args.num_coefs // 2, 2)),
            block_size=args.block_size,
        )
    else:
        cfg = CodecConfig(
            counts=(args.counts,), scales=(args.scales,),
            num_coefs=(args.num_coefs,), block_size=args.block_size,
        )
    mld = MultilevelDictionary.generate(cfg, seed=7)
    gen = SignalGenerator(mld, rates=2e-3)

    ndev = len(jax.devices())
    shard_counts = [s for s in (1, 2, 4, 8, 16, 32) if s <= min(ndev, args.max_shards)]
    results = []
    base_rate = None
    streams_all = None
    if args.decode:
        # decode weak-scaling: fixed per-shard stream load, mesh-sharded
        # reconstruction (parallel.dp.DataParallelDecoder)
        from hsc_tpu.parallel.dp import DataParallelDecoder

        hcoder_all = HierarchicalConvolutionalSparseCoder(mld, backend="jax")
        nb_max = max(shard_counts) * args.blocks_per_shard
        xs_all = gen.generate_signals(nb_max, cfg.block_size, seed=3)
        top = cfg.num_levels - 1
        streams_all = [b[top] for b in hcoder_all.encode_batch(xs_all)]
    for s in shard_counts:
        mesh = make_mesh({"data": s}, devices=jax.devices()[:s])
        nb = s * args.blocks_per_shard
        if args.decode:
            hcoder = HierarchicalConvolutionalSparseCoder(mld, backend="jax")
            dpd = DataParallelDecoder(mesh, hcoder)
            streams = streams_all[:nb]
            run = lambda: jax.block_until_ready(
                dpd.decode_batch_device(streams)
            )
        elif args.hierarchical:
            hcoder = HierarchicalConvolutionalSparseCoder(mld, backend="jax")
            hdp = HierarchicalDataParallelEncoder(mesh, hcoder)
            xs = gen.generate_signals(nb, cfg.block_size, seed=3)
            run = lambda: hdp.encode(xs)
        else:
            coder = ConvolutionalSparseCoder(mld, backend="jax")
            dp = DataParallelEncoder(mesh, coder.mp)
            xs = gen.generate_signals(nb, cfg.block_size, seed=3)
            run = lambda: dp.encode(xs)
        # control: the UNSHARDED batched path at the identical load — on a
        # virtual CPU mesh the host cores are shared, so absolute weak-
        # scaling efficiency measures core saturation, not sharding; the
        # sharded/local ratio isolates the sharding overhead itself
        # (collectives, gather, padding), which is what the virtual mesh can
        # measure honestly.
        if args.decode:
            local = lambda: jax.block_until_ready(
                hcoder.reconstruct_batch_device(streams)
            )
        elif args.hierarchical:
            local = lambda: hcoder.encode_batch(xs)
        else:
            # match dp.encode's host gather so the two paths are comparable
            local = lambda: jax.device_get(
                coder.mp.compute_coefficients_batch(xs)
            )
        for fn in (run, local):
            fn()  # warm compile
        best = float("inf")
        best_local = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
            t0 = time.perf_counter()
            local()
            best_local = min(best_local, time.perf_counter() - t0)
        rate = nb / best
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * s)
        results.append(
            {"shards": s, "blocks": nb, "blocks_per_s": round(rate, 2),
             "weak_scaling_efficiency": round(eff, 3),
             "vs_unsharded_local": round(best_local / best, 3)}
        )
        print(json.dumps(results[-1]), flush=True)
    print(json.dumps({"summary": results}))


if __name__ == "__main__":
    main()
