"""Pre-commit smoke gate — ~20 s of critical-path checks on CPU.

Run this before every commit.  It drives the greedy loop through its real
dispatch (`ops.route` -> the coder's loop stage) so a signature or dispatch
mismatch fails here, not on the card.

Checks:
  1. Routed encode (the XLA loop on CPU) bitwise vs the pinned oracle, and
     the route table: the CUDA kernel on a GPU where it fits, XLA elsewhere.
  2. Hierarchical int8-init encode through the routed loop, bitwise vs the
     forced XLA backend.
  3. Container pack -> unpack -> decode round trip, both decode modes,
     decode bitwise vs the NumPy oracle.
  4. bench.py, chip_smoke.py and __graft_entry__.py import.

Exit 0 = safe to commit.  This is NOT the full suite nor the on-card check
(`python chip_smoke.py` on a GPU) — it is the fast gate.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp


def main() -> int:
    t_start = time.perf_counter()
    from hsc_tpu import MultilevelDictionary, SignalGenerator, make_test_config
    from hsc_tpu.ops import mp_encode_jax

    cfg = make_test_config()
    mld = MultilevelDictionary.generate(cfg, seed=7)
    gen = SignalGenerator(mld, rates=4e-3)
    xs = gen.generate_signals(2, cfg.block_size, seed=3)
    bank = jnp.asarray(mld.augmented(0))
    gram_t = jnp.asarray(np.ascontiguousarray(mld.gram(0).transpose(1, 0, 2)))
    xb = jnp.asarray(xs)[:, :, None]
    nc = cfg.num_coefs[0]

    # -- 1. routed encode vs the pinned oracle; the route table ------------
    from hsc_tpu.models.coder import ConvolutionalSparseCoder
    from hsc_tpu.ops import greedy_cuda
    from hsc_tpu.ops.route import greedy_loop, greedy_loop_route

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests"))
    from pinned import oracle_encode_pinned

    coder = ConvolutionalSparseCoder(mld)
    npos = cfg.num_positions(0)
    assert coder.mp.route(npos) == "xla" and coder.mp.route(npos, "gpu") == "cuda"
    assert greedy_loop_route("gpu", npos=16353, k=64, w=32, num_select=8) == "cuda"
    assert greedy_loop("cuda", coder.mp.settings).func is greedy_cuda.greedy_loop_cuda
    for b, stream in enumerate(coder.encode_batch(xs)):
        ref = oracle_encode_pinned(xs[b][:, None], mld, 0)
        np.testing.assert_array_equal(stream.positions, ref.positions)
        np.testing.assert_array_equal(stream.atoms, ref.atoms)
        np.testing.assert_array_equal(stream.codes, ref.codes)
        assert stream.scale == ref.scale
        single = mp_encode_jax(xb[b], bank, gram_t, num_coefs=nc)
        assert int(single.count) == stream.positions.shape[0]
    print(f"[smoke] 1/4 routed encode bitwise vs oracle, route table ok "
          f"({time.perf_counter() - t_start:.1f}s)", flush=True)

    # -- 2. hierarchical int8-init encode through the routed loop -----------
    from hsc_tpu.config import CodecConfig
    from hsc_tpu.models.coder import HierarchicalConvolutionalSparseCoder

    hcfg = CodecConfig(counts=(12, 6), scales=(12, 18), block_size=512,
                       num_coefs=(40, 24), num_select=8)
    assert hcfg.hier_init == "int8"
    hmld = MultilevelDictionary.generate(hcfg, seed=7)
    hx = np.random.default_rng(5).standard_normal(
        (2, hcfg.block_size)).astype(np.float32)
    hw = HierarchicalConvolutionalSparseCoder(hmld, backend="auto")
    hj = HierarchicalConvolutionalSparseCoder(hmld, backend="jax")
    for gb, wb in zip(hw.encode_batch(hx), hj.encode_batch(hx)):
        for g, w in zip(gb, wb):
            np.testing.assert_array_equal(g.positions, w.positions)
            np.testing.assert_array_equal(g.codes, w.codes)
            assert np.float32(g.scale) == np.float32(w.scale)
    print(f"[smoke] 2/4 hierarchical routed encode bitwise ok "
          f"({time.perf_counter() - t_start:.1f}s)", flush=True)

    # -- 2. container round trip + oracle-bitwise decode, both modes --------
    import dataclasses

    from hsc_tpu.io import unpack_corpus
    from hsc_tpu.oracle import mp_decode
    from hsc_tpu.oracle.mp import mp_decode_integer, rep_quantize
    from hsc_tpu.runtime import CorpusEncoder

    for decode_mode in ("ordered", "integer"):
        cfg_m = dataclasses.replace(cfg, decode_mode=decode_mode)
        mld_m = MultilevelDictionary(cfg_m, mld.dicts)
        enc = CorpusEncoder(mld_m, backend="jax", batch_size=2)
        blob = enc.encode(xs)
        cfg_u, blocks = unpack_corpus(blob)
        assert cfg_u == cfg_m and len(blocks) == len(xs)
        got = enc.decode(blob)
        bank_np = np.asarray(mld.augmented(0))
        for b, block in enumerate(blocks):
            (_, stream), = block
            if decode_mode == "integer":
                rep_q, step = rep_quantize(bank_np, cfg.rep_bits)
                want = mp_decode_integer(stream, rep_q, step, cfg.block_size)
            else:
                want = mp_decode(stream, bank_np, cfg.block_size)
            np.testing.assert_array_equal(
                np.asarray(got[b]).reshape(-1),
                np.asarray(want).astype(got.dtype).reshape(-1),
            )
    print(f"[smoke] 3/4 container round trip + oracle decode ok "
          f"({time.perf_counter() - t_start:.1f}s)", flush=True)

    # -- 3. bench entry points resolve (no run — just the import surface) ---
    import importlib

    for mod in ("hsc_tpu.ops.pipeline", "hsc_tpu.ops.route", "hsc_tpu.learn.kmeans"):
        importlib.import_module(mod)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__  # noqa: F401  (driver entry must stay importable)
    import bench  # noqa: F401
    import chip_smoke  # noqa: F401

    print(f"[smoke] 4/4 bench/chip_smoke/graft import surface ok "
          f"({time.perf_counter() - t_start:.1f}s)", flush=True)
    print(f"[smoke] PASS in {time.perf_counter() - t_start:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
