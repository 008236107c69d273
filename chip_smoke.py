"""On-card smoke test of the codec's main path: encode -> container -> decode.

    python chip_smoke.py          # one NVIDIA GPU
    python chip_smoke.py --four   # four GPUs: data-parallel corpus encode and
                                  # decode, sequence-parallel encode; nothing else

Everything runs in this one process, through the entry points a user calls
(`CorpusEncoder`, `CorpusReader`), at the flagship widths: 16,384-sample
blocks, 64 atoms of width 32, 512 coefficients, batches of 64, dictionaries
and corpora made from seeds.  Every stream, init score and decoded row is
checked against the NumPy oracle (`hsc_tpu.oracle`): bitwise where the spec
is exact, within a stated tolerance where it is a float32 reduction.  Each
greedy-loop route (the CUDA kernel and the XLA loop) is timed warm at the
flagship shape.  Any failed check raises, so the exit code is non-zero and
no result line is printed.  The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

BLOCK = 16384
BATCH = 64
N_BLOCKS = 128  # flat and two-level corpora (two batches each)
N_BLOCKS_FOUR = 256  # four cards: one batch of 64 per card
GOLDEN = (0, 21, 42, 63)  # blocks whose streams are re-run by the oracle
LONG_BLOCK = 4 * BLOCK  # sequence-parallel block, one quarter per card
FUZZ_GEOMETRIES = 4
HIER_FUZZ_GEOMETRIES = 2
# Level-0 init scores are a float32 correlation of 32 products.  Each term
# and the sum are correctly rounded, so the error is at most ~W * 2^-24
# (about 2e-6) of the block's score scale; TF32 products (10-bit mantissa)
# would be off by ~5e-4.  1e-5 separates the two with margin both ways.
INIT_RTOL = 1e-5
# k-means centroids are unit-normalized float32 sums of ~128 windows per
# cluster; float32 rounding keeps them within ~1e-6 of a float64 reference,
# TF32 dots would move them by ~1e-3.
KMEANS_ATOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what: str) -> None:
    if not ok:
        raise AssertionError(f"FAILED: {what}")
    log(f"  ok  {what}")


def timed(fn, reps: int = 2):
    """(result, first-call seconds, best warm seconds); the result is
    fetched to the host inside each timed call."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return out, first, best


def require_gpu(n: int):
    """Stop unless JAX sees at least `n` GPUs; print the card's name."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n:
        sys.exit(f"chip_smoke: needs {n} GPU(s); JAX found {devs}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"device: {devs[0].device_kind} x{len(devs)} (jax platform "
        f"{devs[0].platform}); nvidia-smi name, power limit:")
    log(smi)
    return devs


def flat_config(num_select: int, decode_mode: str = "auto"):
    from hsc_tpu import make_test_config

    return make_test_config(
        counts=(64,), scales=(32,), block_size=BLOCK, num_coefs=(512,),
        num_select=num_select, entropy="rice", decode_mode=decode_mode,
    )


def hier_config():
    from hsc_tpu import make_test_config

    return make_test_config(
        counts=(64, 32), scales=(32, 96), block_size=BLOCK,
        num_coefs=(512, 192), num_select=8, entropy="rice", hier_init="int8",
    )


def corpus(cfg, dict_seed: int, signal_seed: int, n_blocks: int):
    from hsc_tpu import MultilevelDictionary, SignalGenerator

    mld = MultilevelDictionary.generate(cfg, seed=dict_seed)
    xs = SignalGenerator(mld, rates=2e-3).generate_signals(
        n_blocks, cfg.block_size, seed=signal_seed
    )
    return mld, xs


def container_streams(blob: bytes, level: int):
    from hsc_tpu.io import unpack_corpus

    _, blocks = unpack_corpus(blob)
    out = []
    for streams in blocks:
        assert len(streams) == 1 and streams[0][0] == level
        out.append(streams[0][1])
    return out


def events(stream):
    """Event multiset of a stream (Rice containers store events sorted by
    position, so containers compare with greedy order as sets)."""
    return sorted(zip(stream.positions.tolist(), stream.atoms.tolist(),
                      stream.codes.tolist()))


def device_stream(enc, b: int):
    n = int(enc.count[b])
    return (np.asarray(enc.positions[b][:n]), np.asarray(enc.atoms[b][:n]),
            np.asarray(enc.codes[b][:n]), np.float32(enc.scale[b]))


def same_stream(enc, b: int, ref) -> bool:
    pos, atm, cds, scale = device_stream(enc, b)
    return (pos.shape == ref.positions.shape and np.array_equal(pos, ref.positions)
            and np.array_equal(atm, ref.atoms) and np.array_equal(cds, ref.codes)
            and scale == ref.scale)


def same_encoded(a, b) -> bool:
    return all(
        np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
        for f in ("positions", "atoms", "codes", "count", "scale")
    )


def integer_oracle_rows(mld, streams, level: int):
    from hsc_tpu.oracle.mp import mp_decode_integer, rep_quantize

    cfg = mld.config
    rep_q, step = rep_quantize(mld.representations(level)[:, :, None], cfg.rep_bits)
    return np.stack([
        mp_decode_integer(s, rep_q, step, cfg.block_size)[:, 0] for s in streams
    ])


def init_vs_float64(xs, bank, s0) -> float:
    """Largest |card - float64| init score over the checked blocks, relative
    to each block's largest float64 score."""
    worst = 0.0
    for i in GOLDEN:
        win = np.lib.stride_tricks.sliding_window_view(
            xs[i].astype(np.float64), bank.shape[1]
        )
        ref = win @ bank[:, :, 0].astype(np.float64).T  # [npos, K]
        err = np.max(np.abs(np.asarray(s0[i], np.float64).T - ref))
        worst = max(worst, err / np.max(np.abs(ref)))
    return worst


def phase_flat(report: dict) -> None:
    """(b) flat corpus through CorpusEncoder / CorpusReader on both routes,
    golden-loop streams, init scores and integer-decoded rows vs the oracle."""
    import jax.numpy as jnp

    from hsc_tpu.oracle import mp_encode
    from hsc_tpu.ops.encode import encode_init_batched
    from hsc_tpu.runtime import CorpusEncoder, CorpusReader

    mb = N_BLOCKS * BLOCK * 4 / 1e6
    for ns in (1, 8):
        log(f"(b) flat corpus: {N_BLOCKS} blocks, num_select={ns}")
        cfg = flat_config(ns)
        check(cfg.decode_mode == "integer", "decode_mode resolves to 'integer'")
        mld, xs = corpus(cfg, 7, 3, N_BLOCKS)
        ce = CorpusEncoder(mld, batch_size=BATCH)
        mp = ce.coder.coders[0].mp
        check(mp.route(cfg.num_positions(0)) == "cuda", "route: CUDA greedy loop")
        blob, first, warm = timed(lambda: ce.encode(xs))
        log(f"  encode (CUDA route): first {first:.3f} s, warm {warm:.4f} s "
            f"= {mb / warm:.1f} MB/s")
        ce_x = CorpusEncoder(mld, backend="jax", batch_size=BATCH)
        blob_x, first_x, warm_x = timed(lambda: ce_x.encode(xs))
        log(f"  encode (XLA route):  first {first_x:.3f} s, warm {warm_x:.4f} s "
            f"= {mb / warm_x:.1f} MB/s")
        check(blob_x == blob, "CUDA and XLA routes write byte-identical containers")
        report[f"flat_ns{ns}"] = dict(
            encode_cuda_s=warm, encode_xla_s=warm_x, bytes=len(blob))

        # golden loop: the oracle's greedy loop from the card's own init
        bank, gram = mld.augmented(0), mld.gram(0)
        s0, e0, _ = encode_init_batched(
            jnp.asarray(xs[:BATCH])[:, :, None], jnp.asarray(bank)
        )
        enc = mp.compute_coefficients_batch(xs[:BATCH])
        streams = container_streams(blob, 0)
        s0n, e0n = np.asarray(s0), np.asarray(e0)
        for i in GOLDEN:
            ref = mp_encode(xs[i][:, None], bank, gram, num_coefs=512,
                            scores0=s0n[i], energy0=float(e0n[i]), num_select=ns)
            check(same_stream(enc, i, ref),
                  f"golden loop ns={ns} block {i}: card stream == oracle "
                  f"({ref.positions.shape[0]} events)")
            check(events(streams[i]) == events(ref) and streams[i].scale == ref.scale,
                  f"container block {i} holds the oracle's events")
        rel = init_vs_float64(xs, bank, s0n)
        check(rel <= INIT_RTOL, f"level-0 init vs float64: rel err {rel:.3e} <= {INIT_RTOL}")

        rows, first_d, warm_d = timed(lambda: ce.decode(blob))
        log(f"  decode (integer): first {first_d:.3f} s, warm {warm_d:.4f} s "
            f"= {mb / warm_d:.1f} MB/s")
        report[f"flat_ns{ns}"]["decode_s"] = warm_d
        want = integer_oracle_rows(mld, streams, 0)
        check(rows.tobytes() == want.tobytes(),
              f"all {N_BLOCKS} decoded rows == oracle.mp.mp_decode_integer")
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "corpus.hsct")
            with open(path, "wb") as f:
                f.write(blob)
            with CorpusReader(path, mld, batch_size=BATCH) as reader:
                lo, hi = N_BLOCKS // 2 - 4, N_BLOCKS // 2 + 4  # across a batch edge
                check(reader[5].tobytes() == rows[5].tobytes()
                      and np.stack(list(reader.rows(lo, hi))).tobytes()
                      == rows[lo:hi].tobytes(),
                      "CorpusReader rows == decode rows")


def phase_hier(report: dict) -> None:
    """(c) two-level corpus: level-0 golden loop, the int8 level-1 init
    bitwise, level-1 golden loop, container and decoded rows vs the oracle."""
    import jax.numpy as jnp

    from hsc_tpu.oracle import mp_encode
    from hsc_tpu.oracle.mp import (
        bank_quantize_int16, feature_map_int_from_events, int8_init_scores,
    )
    from hsc_tpu.ops.encode import encode_init_batched, quantizer_steps
    from hsc_tpu.runtime import CorpusEncoder

    cfg = hier_config()
    log(f"(c) two-level corpus: {N_BLOCKS} blocks, counts {cfg.counts}, "
        f"scales {cfg.scales}, hier_init {cfg.hier_init}")
    mld, xs = corpus(cfg, 9, 5, N_BLOCKS)
    mb = N_BLOCKS * BLOCK * 4 / 1e6
    ce = CorpusEncoder(mld, batch_size=BATCH)
    coder = ce.coder
    check([c.mp.route(cfg.num_positions(lv)) for lv, c in enumerate(coder.coders)]
          == ["cuda", "cuda"], "route: CUDA greedy loop at both levels")
    blob, first, warm = timed(lambda: ce.encode(xs))
    log(f"  encode (CUDA route): first {first:.3f} s, warm {warm:.4f} s "
        f"= {mb / warm:.1f} MB/s")
    ce_x = CorpusEncoder(mld, backend="jax", batch_size=BATCH)
    blob_x, first_x, warm_x = timed(lambda: ce_x.encode(xs))
    log(f"  encode (XLA route):  first {first_x:.3f} s, warm {warm_x:.4f} s "
        f"= {mb / warm_x:.1f} MB/s")
    check(blob_x == blob, "CUDA and XLA routes write byte-identical containers")
    report["hier"] = dict(encode_cuda_s=warm, encode_xla_s=warm_x, bytes=len(blob))

    mp0, mp1 = coder.coders[0].mp, coder.coders[1].mp
    bank0, bank1 = mld.augmented(0), mld.augmented(1)
    xb = jnp.asarray(xs[:BATCH])[:, :, None]
    s0, e0, _ = encode_init_batched(xb, mp0.bank)
    enc0 = mp0.compute_coefficients_batch(xb)
    m_int = coder.fmap_int_batched(0)(enc0)
    s1, e1, peak1 = mp1.init_int_batched(m_int, enc0.scale)
    sc1, inv1 = quantizer_steps(np.asarray(peak1), cfg.amp_bits)
    enc1 = mp1.loop_stage(s1, e1, sc1, inv1)
    top = container_streams(blob, 1)
    bq, step = bank_quantize_int16(bank1[: cfg.counts[1]])
    s0n, e0n, s1n, e1n = map(np.asarray, (s0, e0, s1, e1))
    for i in GOLDEN:
        ref0 = mp_encode(xs[i][:, None], bank0, mld.gram(0), num_coefs=512,
                         scores0=s0n[i], energy0=float(e0n[i]), num_select=8)
        check(same_stream(enc0, i, ref0), f"level-0 golden loop block {i}")
        fmap = feature_map_int_from_events(ref0, cfg.num_positions(0), bank0.shape[0])
        check(np.asarray(m_int[i]).tobytes() == fmap.tobytes(),
              f"level-0 -> 1 integer hand-off block {i} == oracle")
        want1 = int8_init_scores(fmap, bq, step, ref0.scale)
        check(s1n[i].tobytes() == want1.tobytes(),
              f"level-1 int8 init block {i} == oracle.mp.int8_init_scores (bitwise)")
        seq1 = (fmap.astype(np.float32) * ref0.scale).astype(np.float32)
        ref1 = mp_encode(seq1, bank1, mld.gram(1), num_coefs=192,
                         scores0=want1, energy0=float(e1n[i]), num_select=8,
                         singleton_weight=cfg.singleton_weight, n_raw=cfg.counts[1])
        check(same_stream(enc1, i, ref1),
              f"level-1 golden loop block {i} ({ref1.positions.shape[0]} events)")
        check(events(top[i]) == events(ref1), f"container block {i} == oracle top stream")
    check(init_vs_float64(xs, bank0, s0n) <= INIT_RTOL, "level-0 init vs float64")

    rows, first_d, warm_d = timed(lambda: ce.decode(blob))
    log(f"  decode (integer): warm {warm_d:.4f} s = {mb / warm_d:.1f} MB/s")
    report["hier"]["decode_s"] = warm_d
    check(rows.tobytes() == integer_oracle_rows(mld, top, 1).tobytes(),
          f"all {N_BLOCKS} decoded rows == oracle.mp.mp_decode_integer")


def phase_ordered(report: dict) -> None:
    """(d) decode_mode='ordered' containers: bytes equal oracle.mp.mp_decode."""
    from hsc_tpu.oracle import mp_decode
    from hsc_tpu.runtime import CorpusEncoder

    cfg = flat_config(8, decode_mode="ordered")
    log(f"(d) ordered decode: {BATCH} blocks")
    mld, xs = corpus(cfg, 7, 3, BATCH)
    ce = CorpusEncoder(mld, batch_size=BATCH)
    blob = ce.encode(xs)
    rows, _, warm = timed(lambda: ce.decode(blob))
    log(f"  decode (ordered, XLA scan): warm {warm:.4f} s = "
        f"{BATCH * BLOCK * 4 / 1e6 / warm:.1f} MB/s")
    report["ordered_decode_s"] = warm
    streams = container_streams(blob, 0)
    want = np.stack([mp_decode(s, mld.augmented(0), BLOCK)[:, 0] for s in streams])
    check(rows.tobytes() == want.tobytes(),
          f"all {BATCH} ordered-decode rows == oracle.mp.mp_decode")


def phase_kernels(report: dict) -> None:
    """(e) each greedy-loop decision timed alone at the flagship shape, and
    the decode paths (XLA only) timed alone."""
    import jax.numpy as jnp

    from hsc_tpu.oracle.mp import rep_quantize
    from hsc_tpu.ops.decode import mp_decode_batch_jax, mp_decode_integer_batch_jax
    from hsc_tpu.ops.encode import encode_init_batched, quantizer_steps
    from hsc_tpu.ops.route import greedy_loop

    log("(e) kernels alone at the flagship shape (64 blocks)")
    cfg = flat_config(1)
    mld, xs = corpus(cfg, 7, 3, BATCH)
    bank = jnp.asarray(mld.augmented(0))
    gram_t = jnp.asarray(np.ascontiguousarray(mld.gram(0).transpose(1, 0, 2)))
    (s0, e0, peak), _, t_init = timed(
        lambda: encode_init_batched(jnp.asarray(xs)[:, :, None], bank))
    log(f"  level-0 init conv: {t_init * 1e3:.3f} ms")
    report["init_conv_ms"] = t_init * 1e3
    scale, inv = (jnp.asarray(v) for v in quantizer_steps(np.asarray(peak), 16))
    enc = None
    for ns in (1, 8):
        settings = dict(num_coefs=512, amp_bits=16, tolerance_snr=None,
                        singleton_weight=1.0, n_raw=64, num_select=ns)
        times = {}
        outs = {}
        for route in ("cuda", "xla"):
            loop = greedy_loop(route, settings)
            outs[route], _, times[route] = timed(
                lambda: loop(s0, e0, scale, inv, bank, gram_t), reps=3)
        log(f"  greedy loop ns={ns}: CUDA {times['cuda'] * 1e3:.3f} ms, "
            f"XLA {times['xla'] * 1e3:.3f} ms")
        check(same_encoded(outs["cuda"], outs["xla"]),
              f"greedy loop ns={ns}: CUDA == XLA bitwise")
        report[f"loop_ns{ns}_ms"] = {r: t * 1e3 for r, t in times.items()}
        enc = outs["cuda"] if ns == 1 else enc
    rep_q, step = rep_quantize(mld.representations(0)[:, :, None], cfg.rep_bits)
    amp = (np.asarray(enc.scale) * np.float32(step)).astype(np.float32)
    args = (enc.positions, enc.atoms, enc.codes, enc.count)
    _, _, t_int = timed(lambda: mp_decode_integer_batch_jax(
        *args, jnp.asarray(amp), jnp.asarray(rep_q), n=BLOCK), reps=3)
    _, _, t_ord = timed(lambda: mp_decode_batch_jax(
        *args, enc.scale, bank, n=BLOCK), reps=3)
    log(f"  integer decode (XLA): {t_int * 1e3:.3f} ms; ordered decode "
        f"(XLA scan): {t_ord * 1e3:.3f} ms")
    report["decode_integer_ms"] = t_int * 1e3
    report["decode_ordered_ms"] = t_ord * 1e3


def phase_fuzz(report: dict) -> None:
    """Random geometries.  Flat: CUDA loop == XLA loop == pinned oracle.
    Two-level: both routes write the same container, and the integer
    hand-off and the int8 level-1 init equal the oracle's.  Both: the
    container round trip decodes to the oracle's rows."""
    import jax.numpy as jnp

    from hsc_tpu import MultilevelDictionary, SignalGenerator, make_test_config
    from hsc_tpu.oracle import mp_encode
    from hsc_tpu.oracle.mp import (
        LevelStream, bank_quantize_int16, feature_map_int_from_events,
        int8_init_scores,
    )
    from hsc_tpu.ops.encode import encode_init_batched, quantizer_steps
    from hsc_tpu.ops.route import greedy_loop
    from hsc_tpu.runtime import CorpusEncoder

    rng = np.random.default_rng(2024)
    for g in range(FUZZ_GEOMETRIES):
        k = int(rng.integers(8, 97))
        w = int(rng.integers(8, 200))
        block = int(rng.integers(4 * w, 20000))
        nc = int(rng.integers(16, 400))
        ns = int(rng.choice([1, 2, 4, 8, 16]))
        tol = float(rng.uniform(6, 20)) if g % 2 else None
        cfg = make_test_config(counts=(k,), scales=(w,), block_size=block,
                               num_coefs=(nc,), num_select=ns, tolerance_snr=tol,
                               entropy="rice")
        log(f"(fuzz {g}) K={k} W={w} block={block} coefs={nc} S={ns} tol={tol}")
        mld = MultilevelDictionary.generate(cfg, seed=100 + g)
        xs = SignalGenerator(mld, rates=float(rng.uniform(1e-3, 1e-2))).generate_signals(
            8, block, seed=200 + g)
        bank = jnp.asarray(mld.augmented(0))
        gram_t = jnp.asarray(np.ascontiguousarray(mld.gram(0).transpose(1, 0, 2)))
        s0, e0, peak = encode_init_batched(jnp.asarray(xs)[:, :, None], bank)
        scale, inv = (jnp.asarray(v) for v in quantizer_steps(np.asarray(peak), 16))
        settings = dict(num_coefs=nc, amp_bits=16, tolerance_snr=tol,
                        singleton_weight=1.0, n_raw=k, num_select=ns)
        a = greedy_loop("cuda", settings)(s0, e0, scale, inv, bank, gram_t)
        b = greedy_loop("xla", settings)(s0, e0, scale, inv, bank, gram_t)
        check(same_encoded(a, b), "CUDA == XLA bitwise")
        for i in (0, 7):
            ref = mp_encode(xs[i][:, None], mld.augmented(0), mld.gram(0),
                            num_coefs=nc, tolerance_snr=tol, num_select=ns,
                            scores0=np.asarray(s0[i]), energy0=float(e0[i]))
            check(same_stream(a, i, ref), f"block {i} == pinned oracle")
        ce = CorpusEncoder(mld, batch_size=8)
        blob = ce.encode(xs)
        rows = ce.decode(blob)
        want = integer_oracle_rows(mld, container_streams(blob, 0), 0)
        check(rows.tobytes() == want.tobytes(), "container round trip == oracle rows")
    for g in range(HIER_FUZZ_GEOMETRIES):
        k0, k1 = int(rng.integers(8, 65)), int(rng.integers(4, 33))
        w0 = int(rng.integers(8, 48))
        s1 = w0 + int(rng.integers(8, 120))
        block = int(rng.integers(4 * s1, 12000))
        cfg = make_test_config(
            counts=(k0, k1), scales=(w0, s1), block_size=block,
            num_coefs=(int(rng.integers(32, 300)), int(rng.integers(16, 160))),
            num_select=int(rng.choice([1, 4, 8])), entropy="rice",
        )
        log(f"(fuzz hier {g}) counts={cfg.counts} scales={cfg.scales} "
            f"block={block} coefs={cfg.num_coefs} S={cfg.num_select} "
            f"hier_init={cfg.hier_init}")
        mld = MultilevelDictionary.generate(cfg, seed=300 + g)
        xs = SignalGenerator(mld, rates=float(rng.uniform(1e-3, 1e-2))).generate_signals(
            8, block, seed=400 + g)
        blob = CorpusEncoder(mld, batch_size=8).encode(xs)
        blob_x = CorpusEncoder(mld, backend="jax", batch_size=8).encode(xs)
        check(blob == blob_x, "CUDA and XLA routes write byte-identical containers")
        ce = CorpusEncoder(mld, batch_size=8)
        coder = ce.coder
        enc0 = coder.coders[0].mp.compute_coefficients_batch(xs)
        m_int = coder.fmap_int_batched(0)(enc0)
        s1_dev = np.asarray(coder.coders[1].mp.init_int_batched(m_int, enc0.scale)[0])
        bq, step = bank_quantize_int16(mld.augmented(1)[: cfg.counts[1]])
        for i in (0, 7):
            pos, atm, cds, scale = device_stream(enc0, i)
            fmap = feature_map_int_from_events(
                LevelStream(pos, atm, cds, scale, 0.0, 0.0),
                cfg.num_positions(0), mld.num_atoms(0))
            check(np.asarray(m_int[i]).tobytes() == fmap.tobytes()
                  and s1_dev[i].tobytes()
                  == int8_init_scores(fmap, bq, step, scale).tobytes(),
                  f"block {i}: hand-off and int8 init == oracle")
        rows = ce.decode(blob)
        want = integer_oracle_rows(mld, container_streams(blob, 1), 1)
        check(rows.tobytes() == want.tobytes(), "container round trip == oracle rows")
    report["fuzz_geometries"] = FUZZ_GEOMETRIES + HIER_FUZZ_GEOMETRIES


def phase_kmeans(report: dict) -> None:
    """(f) kmeans_refine_device vs a float64 NumPy reference."""
    import jax.numpy as jnp

    from hsc_tpu.learn.kmeans import kmeans_refine_device

    log("(f) k-means refine: 8192 windows, D=32, K=64, 5 iterations")
    rng = np.random.default_rng(0)
    k, d, m, iters = 64, 32, 8192, 5
    cents = rng.standard_normal((k, d))
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    lab = np.arange(m) % k  # every cluster populated: no dead atoms
    sign = np.where(rng.random(m) < 0.5, -1.0, 1.0)
    windows = (cents[lab] * sign[:, None] * rng.uniform(0.5, 2.0, (m, 1))
               + 0.02 * rng.standard_normal((m, d))).astype(np.float32)
    c0 = cents + 0.05 * rng.standard_normal((k, d))
    c0 = (c0 / np.linalg.norm(c0, axis=1, keepdims=True)).astype(np.float32)
    (got, obj), _, warm = timed(lambda: kmeans_refine_device(
        jnp.asarray(windows), jnp.asarray(c0), iterations=iters))
    ref = c0.astype(np.float64)
    w64 = windows.astype(np.float64)
    for _ in range(iters):
        scores = w64 @ ref.T
        best = np.argmax(np.abs(scores), axis=1)
        val = scores[np.arange(m), best]
        sums = np.zeros_like(ref)
        np.add.at(sums, best, np.where(val >= 0, 1.0, -1.0)[:, None] * w64)
        assert (np.bincount(best, minlength=k) > 0).all()
        ref = sums / np.linalg.norm(sums, axis=1, keepdims=True)
    err = float(np.max(np.abs(np.asarray(got, np.float64) - ref)))
    log(f"  warm {warm * 1e3:.3f} ms")
    check(err <= KMEANS_ATOL, f"centroids vs float64: max abs err {err:.2e} <= {KMEANS_ATOL}")
    report["kmeans_ms"] = warm * 1e3


def phase_determinism() -> None:
    """The level-0 init conv gives the same bytes when compiled again in the
    same process, and a fresh encoder writes the same container.  (Whether
    two processes pick the same conv algorithm is not checked here.)"""
    import jax
    import jax.numpy as jnp

    from hsc_tpu.ops.encode import encode_init_batched
    from hsc_tpu.runtime import CorpusEncoder

    cfg = flat_config(8)
    mld, xs = corpus(cfg, 7, 3, BATCH)
    xb = jnp.asarray(xs)[:, :, None]
    a = np.asarray(encode_init_batched(xb, jnp.asarray(mld.augmented(0)))[0])
    jax.clear_caches()
    b = np.asarray(encode_init_batched(xb, jnp.asarray(mld.augmented(0)))[0])
    check(a.tobytes() == b.tobytes(), "level-0 init bytes identical after a recompile")
    ce = CorpusEncoder(mld, batch_size=BATCH)
    check(ce.encode(xs) == CorpusEncoder(mld, batch_size=BATCH).encode(xs),
          "re-encode with a fresh encoder: identical container")


def phase_four(report: dict) -> None:
    """Four cards: data-parallel corpus encode and decode vs one card, and
    one long block in sequence-parallel mode vs the single-device stream."""
    import jax
    import jax.numpy as jnp

    from hsc_tpu.ops import mp_encode_jax
    from hsc_tpu.parallel import make_mesh, sp_encode
    from hsc_tpu.runtime import CorpusEncoder

    devs = jax.devices()[:4]
    cfg = flat_config(8)
    log(f"(four) data-parallel corpus: {N_BLOCKS_FOUR} blocks over 4 cards")
    mld, xs = corpus(cfg, 7, 3, N_BLOCKS_FOUR)
    mb = N_BLOCKS_FOUR * BLOCK * 4 / 1e6
    one = CorpusEncoder(mld, batch_size=BATCH)
    blob1, _, t1 = timed(lambda: one.encode(xs), reps=1)
    rows1, _, d1 = timed(lambda: one.decode(blob1), reps=1)
    four = CorpusEncoder(mld, batch_size=BATCH, mesh=make_mesh({"data": 4}, devs))
    blob4, _, t4 = timed(lambda: four.encode(xs), reps=1)
    rows4, _, d4 = timed(lambda: four.decode(blob1), reps=1)
    log(f"  encode: 1 card {mb / t1:.1f} MB/s, 4 cards {mb / t4:.1f} MB/s; "
        f"decode: 1 card {mb / d1:.1f} MB/s, 4 cards {mb / d4:.1f} MB/s")
    report["four_dp"] = dict(encode_1_s=t1, encode_4_s=t4, decode_1_s=d1, decode_4_s=d4)
    check(blob4 == blob1, "4-card container byte-identical to the 1-card container")
    check(rows4.tobytes() == rows1.tobytes(), "4-card decoded rows byte-identical")

    log(f"(four) sequence-parallel encode of one {LONG_BLOCK}-sample block")
    x = xs[:4].reshape(-1)[:, None]
    bank = jnp.asarray(mld.augmented(0))
    gram_t = jnp.asarray(np.ascontiguousarray(mld.gram(0).transpose(1, 0, 2)))
    sp, _, t_sp = timed(lambda: sp_encode(
        make_mesh({"seq": 4}, devs), jnp.asarray(x), bank, gram_t, num_coefs=1024),
        reps=1)
    ref, _, t_ref = timed(lambda: mp_encode_jax(
        jnp.asarray(x), bank, gram_t, num_coefs=1024), reps=1)
    log(f"  sequence-parallel {t_sp:.3f} s, single device {t_ref:.3f} s")
    report["four_sp"] = dict(sp_s=t_sp, single_s=t_ref, events=int(ref.count))
    n = int(ref.count)
    check(int(sp.count) == n
          and all(np.array_equal(np.asarray(getattr(sp, f))[:n],
                                 np.asarray(getattr(ref, f))[:n])
                  for f in ("positions", "atoms", "codes"))
          and np.float32(sp.scale) == np.float32(ref.scale),
          f"sequence-parallel stream == single-device stream ({n} events)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-GPU data- and sequence-parallel phase")
    args = parser.parse_args(argv)
    devs = require_gpu(4 if args.four else 1)  # (a)
    report: dict = {}
    t0 = time.perf_counter()
    if args.four:
        phase_four(report)
    else:
        phase_flat(report)
        phase_hier(report)
        phase_ordered(report)
        phase_kernels(report)
        phase_fuzz(report)
        phase_kmeans(report)
        phase_determinism()
    report["seconds"] = time.perf_counter() - t0
    log("report: " + json.dumps(report, sort_keys=True))
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
