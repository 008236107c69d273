"""Headline benchmark — encode throughput on the flagship config, on a GPU.

    python bench.py

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "MB/s", "vs_baseline": N, ...,
   "device": {"platform": "gpu", "kind": ..., "count": N}}

value       = device encode throughput (MB of float32 signal per second),
              flagship config: 16k-sample blocks, 64-atom W=32 dictionary,
              512 coefficients/block, 8-way multi-select sweeps, batches of
              64 blocks through the pipelined encode; the greedy loop runs on
              the route `ops.route` picks (the CUDA kernel on a GPU).
vs_baseline = value / (CPU NumPy oracle encode MB/s) — the reference is pure
              single-threaded NumPy (SURVEY.md §6 publishes no numbers, so
              the in-repo oracle at the same config is the reference proxy).

Every device number is a warm time: each measured call is compiled first,
then timed to `block_until_ready`, best of three.  Without a GPU the script
exits non-zero and prints no result.  Detail lines go to stderr.
"""

import json
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def best_time(fn, reps: int = 3) -> float:
    import jax

    jax.block_until_ready(fn())  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    from hsc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {jax.devices()}")
    log(f"device: {dev.device_kind} x{len(jax.devices())}")

    from hsc_tpu import MultilevelDictionary, SignalGenerator, make_test_config
    from hsc_tpu.learn.kmeans import kmeans_refine_device
    from hsc_tpu.models import HierarchicalConvolutionalSparseCoder
    from hsc_tpu.oracle import mp_encode
    from hsc_tpu.oracle.mp import rep_quantize
    from hsc_tpu.ops.decode import mp_decode_batch_jax, mp_decode_integer_batch_jax
    from hsc_tpu.ops.pipeline import (
        encode_batches_pipelined,
        encode_hierarchical_batches_pipelined,
    )
    from hsc_tpu.ops.route import greedy_loop_route

    cfg = make_test_config(
        counts=(64,), scales=(32,), block_size=16384, num_coefs=(512,)
    )
    mld = MultilevelDictionary.generate(cfg, seed=7)
    B, NBATCH = 64, 4
    xs = SignalGenerator(mld, rates=2e-3).generate_signals(B, cfg.block_size, seed=3)
    block_mb = cfg.block_size * 4 / 1e6
    bank, gram = mld.augmented(0), mld.gram(0)

    # ---- baseline: NumPy oracle (reference proxy), single block ------------
    mp_encode(xs[0][:, None], bank, gram, num_coefs=64)  # warm caches
    oracle_dt = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        mp_encode(xs[0][:, None], bank, gram, num_coefs=512)
        oracle_dt = min(oracle_dt, time.perf_counter() - t0)
    oracle_mbps = block_mb / oracle_dt
    log(f"oracle: {oracle_dt * 1e3:.1f} ms/block -> {oracle_mbps:.2f} MB/s")

    # ---- flat encode, pipelined batches ------------------------------------
    gram_t = jnp.asarray(np.ascontiguousarray(gram.transpose(1, 0, 2)))
    bank_d = jnp.asarray(bank)
    batches = [xs[:, :, None]] * NBATCH
    results = {}
    for ns in (1, 8):
        route = greedy_loop_route(
            dev.platform, npos=cfg.num_positions(0), k=64, w=32, num_select=ns
        )
        dt = best_time(lambda: encode_batches_pipelined(
            batches, bank_d, gram_t, num_coefs=512, num_select=ns))
        results[ns] = NBATCH * B * block_mb / dt
        log(f"encode ns={ns} ({route} loop): {dt * 1e3:.1f} ms for "
            f"{NBATCH * B} blocks -> {results[ns]:.1f} MB/s")

    # ---- decode: integer (format v2) and ordered (v1), XLA ------------------
    enc = jax.device_get(
        encode_batches_pipelined([xs[:, :, None]], bank_d, gram_t, num_coefs=512)[0]
    )
    rep_q, step = rep_quantize(bank, cfg.rep_bits)
    amp_step = (enc.scale.astype(np.float32) * np.float32(step)).astype(np.float32)
    ev = tuple(jnp.asarray(a) for a in (enc.positions, enc.atoms, enc.codes, enc.count))
    dt = best_time(lambda: mp_decode_integer_batch_jax(
        *ev, jnp.asarray(amp_step), jnp.asarray(rep_q), n=cfg.block_size))
    decode_mbps = B * block_mb / dt
    log(f"integer decode: {dt * 1e3:.2f} ms for {B} blocks -> {decode_mbps:.1f} MB/s")
    dt = best_time(lambda: mp_decode_batch_jax(
        *ev, jnp.asarray(enc.scale), bank_d, n=cfg.block_size))
    odec_mbps = B * block_mb / dt
    log(f"ordered decode: {dt * 1e3:.2f} ms for {B} blocks -> {odec_mbps:.1f} MB/s")

    # ---- hierarchical (2-level) pipelined encode ----------------------------
    def hier_rate(hcfg, nb):
        hmld = MultilevelDictionary.generate(hcfg, seed=9)
        hxs = SignalGenerator(hmld, rates=2e-3).generate_signals(
            nb, hcfg.block_size, seed=5)
        coder = HierarchicalConvolutionalSparseCoder(hmld)
        hb = [hxs[:, :, None]] * NBATCH
        dt = best_time(lambda: encode_hierarchical_batches_pipelined(hb, coder))
        return NBATCH * nb * hcfg.block_size * 4 / 1e6 / dt

    hier_mbps = hier_rate(make_test_config(
        counts=(32, 16), scales=(32, 96), block_size=8192,
        num_coefs=(256, 128), num_select=8), 64)
    log(f"hierarchical encode (32+16 atoms, 8k blocks): {hier_mbps:.1f} MB/s")
    hier_flag_mbps = hier_rate(make_test_config(
        counts=(64, 32), scales=(32, 96), block_size=16384,
        num_coefs=(512, 192), num_select=8), 64)
    log(f"hierarchical flagship encode (64+32 atoms): {hier_flag_mbps:.1f} MB/s")

    # ---- dictionary learning: device-resident k-means refinement ----------
    M, D, K, ITERS = 65536, 32, 64, 20
    lrng = np.random.default_rng(0)
    lflat = jnp.asarray(lrng.standard_normal((M, D)).astype(np.float32))
    lcents = lrng.standard_normal((K, D)).astype(np.float32)
    lcents = jnp.asarray(lcents / np.linalg.norm(lcents, axis=1, keepdims=True))
    dt = best_time(lambda: kmeans_refine_device(lflat, lcents, iterations=ITERS))
    learn_rate = M * ITERS / dt / 1e6
    log(f"k-means refine: {dt * 1e3:.1f} ms for {ITERS} iterations over {M} "
        f"windows -> {learn_rate:.1f} M window-assignments/s")

    print(json.dumps({
        "metric": "encode throughput, 16k-sample/64-atom/512-coef blocks "
                  "(flagship config, 8-way multi-select sweeps)",
        "value": round(results[8], 2),
        "unit": "MB/s",
        "vs_baseline": round(results[8] / oracle_mbps, 2),
        "encode_ns1_mb_s": round(results[1], 2),
        "decode_integer_mb_s": round(decode_mbps, 2),
        "decode_ordered_mb_s": round(odec_mbps, 2),
        "encode_hier_mb_s": round(hier_mbps, 2),
        "encode_hier_flagship_mb_s": round(hier_flag_mbps, 2),
        "learn_mwindows_s": round(learn_rate, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
