"""Serving-surface benchmark: random-access decode latency + streaming rate.

Measures, on a 2048-block flagship corpus (16k samples/block):
  1. single-block random-access latency via `CorpusEncoder.decode_blocks`
     on an indexed container (seek + unpack + device decode + fetch) —
     median/p90 over N seeks;
  2. `decode_stream` steady-state throughput (bounded memory, pipelined);
  3. the same seek latency WITHOUT the footer (header-scan fallback cost).

Usage: python scripts/bench_serving.py [--blocks 2048] [--seeks 32]
       [--platform cpu|gpu] [--entropy rice|fixed]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=2048)
    ap.add_argument("--seeks", type=int, default=32)
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    ap.add_argument("--entropy", default="rice", choices=["rice", "fixed"])
    args = ap.parse_args()

    if args.platform:
        import jax

        jax.config.update(
            "jax_platforms", "cuda" if args.platform == "gpu" else "cpu"
        )
    from hsc_tpu import MultilevelDictionary, SignalGenerator, make_test_config
    from hsc_tpu.io import read_index
    from hsc_tpu.runtime import CorpusEncoder
    from hsc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    cfg = make_test_config(
        counts=(64,), scales=(32,), block_size=16384, num_coefs=(512,),
        entropy=args.entropy,
    )
    mld = MultilevelDictionary.generate(cfg, seed=7)
    gen = SignalGenerator(mld, rates=2e-3)
    nb = args.blocks
    xs = gen.generate_signals(min(nb, 64), cfg.block_size, seed=3)
    xs = np.tile(xs, (-(-nb // xs.shape[0]), 1))[:nb]
    codec = CorpusEncoder(mld, batch_size=64)
    t0 = time.time()
    blob = codec.encode(xs, index=True)
    print(f"encoded {nb} blocks in {time.time()-t0:.1f}s "
          f"({len(blob)} bytes)", file=sys.stderr, flush=True)
    offsets = read_index(blob)
    assert offsets is not None
    plain = blob[: int(offsets[-1])]  # strip the footer -> scan fallback

    rng = np.random.default_rng(0)
    targets = rng.integers(0, nb, args.seeks)

    def seek_times(container):
        ts = []
        for b in targets:
            t0 = time.perf_counter()
            row = codec.decode_blocks(container, [int(b)])
            _ = row.sum()  # host-side touch: the fetch already happened
            ts.append(time.perf_counter() - t0)
        return np.array(ts) * 1e3

    _ = codec.decode_blocks(blob, [0])  # warm the compile
    t_idx = seek_times(blob)
    t_scan = seek_times(plain)

    # CorpusReader: offsets resolved once — the steady-state serving number
    import tempfile

    from hsc_tpu.runtime import CorpusReader

    with tempfile.NamedTemporaryFile(suffix=".hsct", delete=False) as f:
        f.write(blob)
        path = f.name
    with CorpusReader(path, mld, batch_size=64) as rd:
        _ = rd[0]
        ts = []
        for b in targets:
            t0 = time.perf_counter()
            _ = rd[int(b)].sum()
            ts.append(time.perf_counter() - t0)
    t_reader = np.array(ts) * 1e3
    os.unlink(path)

    # streaming rate + serving byte-identity: rows seen by the streaming
    # path must equal the random-access rows for the seek targets
    want = {int(b): None for b in targets}
    t0 = time.perf_counter()
    n_rows = 0
    for b, row in enumerate(codec.decode_stream(blob)):
        if b in want:
            want[b] = row.tobytes()
        n_rows += 1
    dt = time.perf_counter() - t0
    stream_mb_s = n_rows * cfg.block_size * 4 / 1e6 / dt
    sample = sorted(want)[:8]
    seek_rows = codec.decode_blocks(blob, sample)
    ok = all(seek_rows[j].tobytes() == want[b] for j, b in enumerate(sample))
    print(f"serving rows byte-identical to stream: {ok}", file=sys.stderr)
    assert ok

    # ---- encode serving latency: single-block and single-batch encode
    # through the production 3-stage path, with the fixed dispatch+fetch
    # round trip of a trivial program measured alongside (the encode path
    # pays it twice: once for the peak fetch, once for the stream fetch) --
    import jax
    import jax.numpy as jnp

    trivial = jax.jit(lambda v: v + 1)
    _ = jax.device_get(trivial(jnp.float32(0)))
    ts = []
    for _i in range(12):
        t0 = time.perf_counter()
        _ = jax.device_get(trivial(jnp.float32(_i)))
        ts.append(time.perf_counter() - t0)
    rtt_ms = float(np.median(np.array(ts) * 1e3))

    mp = codec.coder.coders[0].mp
    enc_lat = {}
    for bsz in (1, 8):
        xb = jnp.asarray(xs[:bsz])[:, :, None]
        _ = mp.compute_coefficients_batch(xb)  # warm (compile)
        ts = []
        for _i in range(12):
            t0 = time.perf_counter()
            enc = mp.compute_coefficients_batch(xb)
            _ = np.asarray(jax.device_get(enc.count))
            ts.append(time.perf_counter() - t0)
        enc_lat[bsz] = np.array(ts) * 1e3
    print(
        f"encode latency b=1: {np.median(enc_lat[1]):.1f} ms median "
        f"(rtt {rtt_ms:.1f} ms x2 round trips)", file=sys.stderr,
    )

    out = {
        "blocks": nb,
        "entropy": args.entropy,
        "seek_ms_median": round(float(np.median(t_idx)), 2),
        "reader_ms_median": round(float(np.median(t_reader)), 2),
        "seek_ms_p90": round(float(np.percentile(t_idx, 90)), 2),
        "seek_scan_ms_median": round(float(np.median(t_scan)), 2),
        "stream_mb_s": round(stream_mb_s, 1),
        "encode_latency_ms_b1": round(float(np.median(enc_lat[1])), 2),
        "encode_latency_ms_b1_p90": round(
            float(np.percentile(enc_lat[1], 90)), 2
        ),
        "encode_latency_ms_b8": round(float(np.median(enc_lat[8])), 2),
        "dispatch_rtt_ms": round(rtt_ms, 2),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
