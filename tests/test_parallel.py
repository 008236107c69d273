"""Multi-device tests on the 8-way virtual CPU mesh (SURVEY.md §4 (b)):
data-parallel encode determinism, context-parallel (halo) encode vs
single-device streams, distributed k-means replica consistency."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from hsc_tpu import SignalGenerator, make_test_config, MultilevelDictionary
from hsc_tpu.models import ConvolutionalSparseCoder
from hsc_tpu.ops import mp_encode_jax
from hsc_tpu.parallel import (
    DataParallelEncoder,
    distributed_kmeans_step,
    make_mesh,
    sp_encode,
)
from hsc_tpu.learn.kmeans import kmeans_assign_update, normalize_centroids


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must force 8 virtual CPU devices"
    return make_mesh({"data": 8})


@pytest.fixture(scope="module")
def seq_mesh():
    return make_mesh({"seq": 4}, devices=jax.devices()[:4])


def test_make_mesh_shapes():
    m = make_mesh({"data": 4, "model": 2})
    assert m.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        make_mesh({"data": 5})


def test_dp_encode_matches_local(mesh, mld1):
    """Sharded DP encode must produce exactly the same streams as the
    single-device batched path, in original block order."""
    gen = SignalGenerator(mld1, rates=4e-3)
    xs = gen.generate_signals(16, mld1.config.block_size, seed=51)
    coder = ConvolutionalSparseCoder(mld1)
    local = coder.encode_batch(xs)
    dp = DataParallelEncoder(mesh, coder.mp)
    enc = dp.encode(xs)
    assert enc.count.shape[0] == 16
    for b in range(16):
        n = int(enc.count[b])
        assert n == local[b].positions.shape[0], f"block {b}"
        np.testing.assert_array_equal(enc.positions[b][:n], local[b].positions)
        np.testing.assert_array_equal(enc.codes[b][:n], local[b].codes)
        assert np.float32(enc.scale[b]) == local[b].scale


def test_dp_encode_pads_ragged_batch(mesh, mld1):
    gen = SignalGenerator(mld1, rates=4e-3)
    xs = gen.generate_signals(5, mld1.config.block_size, seed=52)  # 5 % 8 != 0
    coder = ConvolutionalSparseCoder(mld1)
    dp = DataParallelEncoder(mesh, coder.mp)
    enc = dp.encode(xs)
    assert enc.count.shape[0] == 5


def test_sp_encode_matches_single_device(seq_mesh, mld1):
    """Context-parallel encode of ONE block sharded over 4 devices emits the
    single-device stream (boundary-exact halo + replicated greedy loop)."""
    cfg = mld1.config
    gen = SignalGenerator(mld1, rates=4e-3)
    x = gen.generate_signals(1, cfg.block_size, seed=61)[0]
    bank = mld1.augmented(0)
    gram_t = np.ascontiguousarray(mld1.gram(0).transpose(1, 0, 2))

    single = mp_encode_jax(
        jnp.asarray(x)[:, None], jnp.asarray(bank), jnp.asarray(gram_t),
        num_coefs=cfg.num_coefs[0],
    )
    sp = sp_encode(
        seq_mesh, jnp.asarray(x)[:, None], jnp.asarray(bank), jnp.asarray(gram_t),
        num_coefs=cfg.num_coefs[0],
    )
    n_single = int(single.count)
    n_sp = int(sp.count)
    assert n_sp == n_single
    np.testing.assert_array_equal(
        np.asarray(sp.positions[:n_sp]), np.asarray(single.positions[:n_single])
    )
    np.testing.assert_array_equal(
        np.asarray(sp.atoms[:n_sp]), np.asarray(single.atoms[:n_single])
    )
    np.testing.assert_array_equal(
        np.asarray(sp.codes[:n_sp]), np.asarray(single.codes[:n_single])
    )
    assert np.float32(sp.scale) == np.float32(single.scale)


def test_sp_encode_snr_stop(seq_mesh, mld1):
    """SP with an SNR stop: the stream reaches the target and matches the
    single-device stream event for event (e0 is injected from one full-array
    reduction, so the stop is bitwise; see also the borderline test below)."""
    cfg = mld1.config
    gen = SignalGenerator(mld1, rates=4e-3)
    x = gen.generate_signals(1, cfg.block_size, seed=62)[0]
    bank = mld1.augmented(0)
    gram_t = np.ascontiguousarray(mld1.gram(0).transpose(1, 0, 2))
    tol = 6.0

    single = mp_encode_jax(
        jnp.asarray(x)[:, None], jnp.asarray(bank), jnp.asarray(gram_t),
        num_coefs=cfg.num_coefs[0], tolerance_snr=tol,
    )
    sp = sp_encode(
        seq_mesh, jnp.asarray(x)[:, None], jnp.asarray(bank),
        jnp.asarray(gram_t), num_coefs=cfg.num_coefs[0], tolerance_snr=tol,
    )
    n = int(single.count)
    assert 0 < n < cfg.num_coefs[0], "config must stop on SNR, not budget"
    e0 = float(np.sum(np.square(x, dtype=np.float32)))
    e_res = float(sp.energy_res)
    assert 10 * np.log10(e0 / e_res) >= tol
    assert int(sp.count) == n
    np.testing.assert_array_equal(
        np.asarray(sp.positions[:n]), np.asarray(single.positions[:n])
    )
    np.testing.assert_array_equal(
        np.asarray(sp.codes[:n]), np.asarray(single.codes[:n])
    )


def test_sp_encode_rejects_bad_shapes(seq_mesh, mld1):
    bank = mld1.augmented(0)
    gram_t = mld1.gram(0).transpose(1, 0, 2)
    with pytest.raises(ValueError):
        sp_encode(
            seq_mesh, jnp.zeros((1026, 1)), jnp.asarray(bank),
            jnp.asarray(gram_t), num_coefs=4,
        )


def test_distributed_kmeans_matches_single(mesh):
    """psum'd sharded update == single-device update, bit for bit."""
    rng = np.random.default_rng(0)
    windows = rng.standard_normal((256, 32)).astype(np.float32)
    cents = rng.standard_normal((8, 32)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)

    stats = kmeans_assign_update(jnp.asarray(windows), jnp.asarray(cents))
    ref = np.asarray(normalize_centroids(stats.sums, stats.counts, jnp.asarray(cents)))

    new, obj = distributed_kmeans_step(mesh, jnp.asarray(windows), jnp.asarray(cents))
    new = np.asarray(new)
    # psum changes fp association of the sums; allow ulp-level tolerance
    np.testing.assert_allclose(new, ref, atol=1e-5, rtol=1e-5)
    assert obj > 0


def test_distributed_kmeans_loop_matches_local(mesh):
    """The scanned sharded refinement (incl. dead-atom reset) matches the
    local device loop at 8-way sharding (psum reassociation ulps allowed)."""
    from hsc_tpu.learn.kmeans import kmeans_refine_device
    from hsc_tpu.parallel.learn import distributed_kmeans

    rng = np.random.default_rng(3)
    windows = rng.standard_normal((256, 32)).astype(np.float32)
    windows[5] = 0  # silent window: excluded from reseeding on both paths
    cents = rng.standard_normal((8, 32)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    cents[2] = 0  # dead on the first step: exercises the reset path

    loc_c, loc_obj = kmeans_refine_device(
        jnp.asarray(windows), jnp.asarray(cents), iterations=6
    )
    dist_c, dist_obj = distributed_kmeans(
        mesh, jnp.asarray(windows), jnp.asarray(cents), 6
    )
    np.testing.assert_allclose(
        np.asarray(dist_c), np.asarray(loc_c), atol=1e-5, rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(dist_obj), np.asarray(loc_obj), rtol=1e-5
    )


def test_tp_encode_matches_single_device(mld1):
    """Atom-sharded (tensor-parallel) encode over 4 devices emits the
    single-device stream (16 atoms / 4 shards)."""
    from hsc_tpu.parallel import tp_encode

    cfg = mld1.config
    gen = SignalGenerator(mld1, rates=4e-3)
    x = gen.generate_signals(1, cfg.block_size, seed=63)[0]
    bank = mld1.augmented(0)
    gram = mld1.gram(0)
    gram_t = np.ascontiguousarray(gram.transpose(1, 0, 2))
    mesh = make_mesh({"model": 4}, devices=jax.devices()[:4])

    single = mp_encode_jax(
        jnp.asarray(x)[:, None], jnp.asarray(bank), jnp.asarray(gram_t),
        num_coefs=cfg.num_coefs[0],
    )
    tp = tp_encode(
        mesh, jnp.asarray(x)[:, None], jnp.asarray(bank), jnp.asarray(gram),
        num_coefs=cfg.num_coefs[0],
    )
    n = int(single.count)
    assert int(tp.count) == n
    np.testing.assert_array_equal(np.asarray(tp.positions[:n]), np.asarray(single.positions[:n]))
    np.testing.assert_array_equal(np.asarray(tp.atoms[:n]), np.asarray(single.atoms[:n]))
    np.testing.assert_array_equal(np.asarray(tp.codes[:n]), np.asarray(single.codes[:n]))
    assert np.float32(tp.scale) == np.float32(single.scale)


def test_learner_with_mesh_close_to_local(mesh):
    """Mesh-sharded k-means training produces a dictionary close to the
    single-device one (psum reassociation allows ulp drift that can flip
    borderline assignments; require strong atom-level agreement)."""
    from hsc_tpu.learn import ConvolutionalDictionaryLearner
    from hsc_tpu import SignalGenerator, MultilevelDictionary, make_test_config

    cfg = make_test_config(counts=(6,), scales=(12,), num_coefs=(16,), block_size=512)
    mld = MultilevelDictionary.generate(cfg, seed=5)
    xs = SignalGenerator(mld, rates=2e-2).generate_signals(8, 512, seed=6)

    def learn(mesh_arg):
        l = ConvolutionalDictionaryLearner(
            6, 12, 1, algorithm="kmean", num_windows=512, iterations=8, seed=0
        )
        return l.train(xs, mesh=mesh_arg)

    local = learn(None)
    sharded = learn(mesh)
    assert sharded.shape == local.shape
    # every local atom has a near-identical sharded counterpart
    a = local.reshape(6, -1)
    b = sharded.reshape(6, -1)
    sims = np.abs(a @ b.T)
    assert float(np.min(np.max(sims, axis=1))) > 0.99


def test_dp_encode_multihost_single_process(mesh, mld1):
    """encode_multihost degenerates to encode for one process."""
    gen = SignalGenerator(mld1, rates=4e-3)
    xs = gen.generate_signals(8, mld1.config.block_size, seed=53)
    coder = ConvolutionalSparseCoder(mld1)
    dp = DataParallelEncoder(mesh, coder.mp)
    a = dp.encode(xs)
    b = dp.encode_multihost(xs, n_global=8)
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(a.count, b.count)


def test_dp_encode_auto_route_matches_local(mesh, mld1):
    """DP with the routed loop (backend='auto': XLA on a CPU mesh, the CUDA
    kernel per shard inside shard_map on GPUs) emits the local encoder's
    streams."""
    gen = SignalGenerator(mld1, rates=4e-3)
    xs = gen.generate_signals(8, mld1.config.block_size, seed=54)
    coder = ConvolutionalSparseCoder(mld1, backend="auto")
    ref = coder.mp.compute_coefficients_batch(xs)

    dp = DataParallelEncoder(mesh, coder.mp)
    out = dp.encode(xs)
    np.testing.assert_array_equal(out.codes, ref.codes)
    np.testing.assert_array_equal(out.positions, ref.positions)
    np.testing.assert_array_equal(out.count, ref.count)


def _assert_streams_equal(a, b):
    n = int(b.count)
    assert int(a.count) == n
    np.testing.assert_array_equal(np.asarray(a.positions[:n]), np.asarray(b.positions[:n]))
    np.testing.assert_array_equal(np.asarray(a.atoms[:n]), np.asarray(b.atoms[:n]))
    np.testing.assert_array_equal(np.asarray(a.codes[:n]), np.asarray(b.codes[:n]))
    assert np.float32(a.scale) == np.float32(b.scale)


def test_sp_encode_num_select_matches_single_device(seq_mesh, mld1):
    """Multi-select sweeps in the context-parallel mode:
    segments span shards; streams must be bitwise the single-device XLA
    multi-select path's."""
    cfg = mld1.config
    x = SignalGenerator(mld1, rates=4e-3).generate_signals(
        1, cfg.block_size, seed=65
    )[0]
    bank = mld1.augmented(0)
    gram_t = np.ascontiguousarray(mld1.gram(0).transpose(1, 0, 2))
    for ns in (2, 4):
        single = mp_encode_jax(
            jnp.asarray(x)[:, None], jnp.asarray(bank), jnp.asarray(gram_t),
            num_coefs=cfg.num_coefs[0], num_select=ns,
        )
        sp = sp_encode(
            seq_mesh, jnp.asarray(x)[:, None], jnp.asarray(bank),
            jnp.asarray(gram_t), num_coefs=cfg.num_coefs[0], num_select=ns,
        )
        _assert_streams_equal(sp, single)


def test_tp_encode_num_select_matches_single_device(mld1):
    """Multi-select sweeps in the tensor-parallel mode."""
    from hsc_tpu.parallel import tp_encode

    cfg = mld1.config
    x = SignalGenerator(mld1, rates=4e-3).generate_signals(
        1, cfg.block_size, seed=66
    )[0]
    bank = mld1.augmented(0)
    gram = mld1.gram(0)
    gram_t = np.ascontiguousarray(gram.transpose(1, 0, 2))
    mesh = make_mesh({"model": 4}, devices=jax.devices()[:4])
    for ns in (2, 4):
        single = mp_encode_jax(
            jnp.asarray(x)[:, None], jnp.asarray(bank), jnp.asarray(gram_t),
            num_coefs=cfg.num_coefs[0], num_select=ns,
        )
        tp = tp_encode(
            mesh, jnp.asarray(x)[:, None], jnp.asarray(bank),
            jnp.asarray(gram), num_coefs=cfg.num_coefs[0], num_select=ns,
        )
        _assert_streams_equal(tp, single)


def test_sp_encode_tolerance_snr_stop(seq_mesh, mld1):
    """SP with an SNR stop is bitwise the single-device encoder: e0 is one
    full-array init reduction injected into the sharded loop (never a psum of
    shard partials), so the stop decision cannot flip even at the threshold."""
    cfg = mld1.config
    x = SignalGenerator(mld1, rates=4e-3).generate_signals(
        1, cfg.block_size, seed=67
    )[0]
    bank = mld1.augmented(0)
    gram_t = np.ascontiguousarray(mld1.gram(0).transpose(1, 0, 2))
    tol = 4.0
    single = mp_encode_jax(
        jnp.asarray(x)[:, None], jnp.asarray(bank), jnp.asarray(gram_t),
        num_coefs=cfg.num_coefs[0], tolerance_snr=tol,
    )
    sp = sp_encode(
        seq_mesh, jnp.asarray(x)[:, None], jnp.asarray(bank),
        jnp.asarray(gram_t), num_coefs=cfg.num_coefs[0], tolerance_snr=tol,
    )
    assert np.float32(sp.energy0) == np.float32(single.energy0)
    _assert_streams_equal(sp, single)
    snr = 10 * np.log10(float(sp.energy0) / max(float(sp.energy_res), 1e-20))
    assert snr >= tol


def test_sp_encode_snr_stop_borderline(seq_mesh, mld1):
    """SNR stop exactly AT the threshold: tolerance is set to the SNR the
    single-device stream achieves at its final event, so the stop comparison
    `e_res <= e0 * 10^(-tol/10)` lands within float ulps of equality — the
    regime where the old psum'd-e0 SP could flip by one event.  The stream
    must be bitwise identical regardless."""
    cfg = mld1.config
    x = SignalGenerator(mld1, rates=4e-3).generate_signals(
        1, cfg.block_size, seed=68
    )[0]
    bank = mld1.augmented(0)
    gram_t = np.ascontiguousarray(mld1.gram(0).transpose(1, 0, 2))
    probe = mp_encode_jax(
        jnp.asarray(x)[:, None], jnp.asarray(bank), jnp.asarray(gram_t),
        num_coefs=cfg.num_coefs[0], tolerance_snr=5.0,
    )
    assert 0 < int(probe.count) < cfg.num_coefs[0]
    # the exact SNR at the stop event — re-running at this tolerance puts the
    # threshold right on the achieved residual energy
    tol = 10.0 * float(
        np.log10(float(probe.energy0) / float(probe.energy_res))
    )
    for t in (tol, np.nextafter(tol, 0.0), np.nextafter(tol, np.inf)):
        single = mp_encode_jax(
            jnp.asarray(x)[:, None], jnp.asarray(bank), jnp.asarray(gram_t),
            num_coefs=cfg.num_coefs[0], tolerance_snr=float(t),
        )
        sp = sp_encode(
            seq_mesh, jnp.asarray(x)[:, None], jnp.asarray(bank),
            jnp.asarray(gram_t), num_coefs=cfg.num_coefs[0],
            tolerance_snr=float(t),
        )
        assert np.float32(sp.energy0) == np.float32(single.energy0)
        _assert_streams_equal(sp, single)
