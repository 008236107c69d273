"""Tensor-parallel greedy MP — dictionary atoms sharded over 'model'
(SURVEY.md §2.3 P2: for very large K, each chip scores its atom shard and the
global winner is reduced over the mesh).

Per iteration:
  * each shard keeps scores for its K/S atoms and an incrementally-maintained
    local colmax; the spec's two-stage selection becomes
    `pmax` over shards of per-position maxima (position stage), then winner
    extraction on the shard owning the best atom with a global atom-index
    tie-break (`pmin` on the global atom id), then one packed `psum`
    broadcast of (atom, code, score);
  * the update is local by construction: shard rows g need
    ``G[g, f_win, lag]`` — the Gram tensor is sharded on its FIRST axis, so
    every shard holds exactly the rows it updates; no Gram data moves.

Three small collectives per retained coefficient (same budget as the
sequence-parallel mode); use when K is too large for one device's memory.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.encode import EncodedBlock


def tp_encode(
    mesh: Mesh,
    x: jax.Array,
    bank: jax.Array,
    gram: jax.Array,
    *,
    num_coefs: int,
    amp_bits: int = 16,
    tolerance_snr: float | None = None,
    singleton_weight: float = 1.0,
    n_raw: int | None = None,
    num_select: int = 1,
    axis: str = "model",
) -> EncodedBlock:
    """Encode ONE block ``x [N, C]`` with atoms sharded over `axis`.

    `gram` is the UNtransposed Gram tensor ``G[g, f, lag]`` (sharded on g).
    Emits the single-device stream bit-for-bit given identical correlation
    values (replicated greedy arithmetic; all shards return identical event
    buffers).  `num_select > 1` runs the spec's multi-select sweeps
    (reference `nbBlocks`; see `oracle.mp.mp_encode`): the sweep-start
    snapshot is one pmax of the local colmaxes, then each segment's atom
    stage runs the usual pmax/pmin/psum winner extraction against the
    *current* sharded scores.
    """
    k, w, c = bank.shape
    if n_raw is None:
        n_raw = k
    s = int(mesh.shape[axis])
    if k % s != 0:
        raise ValueError(f"K={k} must divide the {axis}-axis size {s}")
    kl = k // s
    x = jnp.asarray(x, dtype=jnp.float32)
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    npos = n - w + 1
    lag = 2 * w - 1
    # spec segment length for multi-select sweeps (oracle.mp.mp_encode)
    seg_len = 128 * (-(-npos // (128 * num_select))) if num_select > 1 else 0
    maxcode = float((1 << (amp_bits - 1)) - 1)
    snr_factor = 10.0 ** (-tolerance_snr / 10.0) if tolerance_snr is not None else None

    def init_fn(x_rep, bank_loc):
        lhs = x_rep.T[None]
        rhs = bank_loc.transpose(0, 2, 1)
        scores0 = jax.lax.conv_general_dilated(
            lhs, rhs, (1,), "VALID",
            dimension_numbers=("NCH", "OIH", "NCH"),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )[0]  # [KL, npos]
        peak = jax.lax.pmax(jnp.max(jnp.abs(scores0)), axis)
        e0 = jnp.sum(jnp.square(x_rep))  # replicated input -> identical
        return scores0, e0, peak

    def shard_fn(scores0, e0, scale, inv_scale, bank_loc, gram_loc):
        # scores0: this shard's [KL, npos] atoms; scale / inv_scale are the
        # host-computed spec divisions (ops.encode.quantizer_steps).
        sid = jax.lax.axis_index(axis)
        g0 = sid * kl  # first global atom id of this shard
        weights = jnp.where(
            (g0 + jnp.arange(kl)) < n_raw,
            jnp.float32(1),
            jnp.float32(singleton_weight),
        )
        snr_thr = (
            e0 * jnp.float32(snr_factor) if snr_factor is not None
            else jnp.float32(-1)
        )

        scores_pad = jnp.zeros((kl, npos + 2 * w - 2), dtype=jnp.float32)
        scores_pad = jax.lax.dynamic_update_slice(scores_pad, scores0, (0, w - 1))
        colmax_pad = jnp.zeros((npos + 2 * w - 2,), dtype=jnp.float32)
        colmax_pad = jax.lax.dynamic_update_slice(
            colmax_pad, jnp.max(jnp.abs(scores0) * weights[:, None], axis=0), (w - 1,)
        )
        big = jnp.int32(k + 1)

        def body(carry, _):
            scores_pad, colmax_pad, e_res, done, positions, atoms, codes, count = carry
            # position stage: global per-position max = pmax of local colmax
            colmax_loc = jax.lax.dynamic_slice(colmax_pad, (w - 1,), (npos,))
            colmax_glob = jax.lax.pmax(colmax_loc, axis)
            t = jnp.argmax(colmax_glob).astype(jnp.int32)  # ties: lowest position
            # atom stage: owner = shard whose local column max matches the
            # global; tie-break lowest GLOBAL atom id via pmin
            col = jax.lax.dynamic_slice(scores_pad, (0, t + (w - 1)), (kl, 1))[:, 0]
            wcol = jnp.abs(col) * weights
            f_loc = jnp.argmax(wcol).astype(jnp.int32)
            v_loc = wcol[f_loc]
            v_glob = colmax_glob[t]
            f_cand = jnp.where(v_loc == v_glob, g0 + f_loc, big).astype(jnp.int32)
            f_glob = jax.lax.pmin(f_cand, axis)
            am_winner = f_cand == f_glob
            s_loc = col[f_loc]
            y = s_loc * inv_scale
            r = jnp.floor(jnp.abs(y) + jnp.float32(0.5)) * jnp.sign(y)
            code_loc = jnp.clip(r, -maxcode, maxcode).astype(jnp.int32)
            packed = jnp.where(
                am_winner,
                jnp.stack([code_loc.astype(jnp.float32), s_loc]),
                jnp.zeros((2,), jnp.float32),
            )
            code_g, s_val = jax.lax.psum(packed, axis)
            code = code_g.astype(jnp.int32)

            emit = jnp.logical_and(jnp.logical_not(done), code != 0)
            c_hat = jnp.where(emit, code.astype(jnp.float32) * scale, jnp.float32(0))

            positions = positions.at[count].set(jnp.where(emit, t, positions[count]))
            atoms = atoms.at[count].set(jnp.where(emit, f_glob, atoms[count]))
            codes = codes.at[count].set(jnp.where(emit, code, codes[count]))
            count = count + emit.astype(jnp.int32)

            e_step = jax.lax.optimization_barrier(jnp.float32(2.0) * c_hat * s_val)
            e_sq = jax.lax.optimization_barrier(c_hat * c_hat)
            e_res = jnp.where(emit, (e_res - e_step) + e_sq, e_res)

            # local update: this shard's Gram rows against the global winner
            gram_rows = jax.lax.dynamic_slice(
                gram_loc, (0, f_glob, 0), (kl, 1, lag)
            )[:, 0, :]  # [KL, lag] = G[g_local, f_win, :]
            window = jax.lax.dynamic_slice(scores_pad, (0, t), (kl, lag))
            window = window - jax.lax.optimization_barrier(c_hat * gram_rows)
            scores_pad = jax.lax.dynamic_update_slice(scores_pad, window, (0, t))
            colmax_pad = jax.lax.dynamic_update_slice(
                colmax_pad,
                jnp.max(jnp.abs(window) * weights[:, None], axis=0),
                (t,),
            )
            done = jnp.logical_or(
                jnp.logical_or(done, code == 0),
                jnp.logical_and(emit, e_res <= snr_thr),
            )
            return (
                scores_pad, colmax_pad, e_res, done, positions, atoms, codes, count,
            ), None

        def seg_body(j, carry):
            # one segment of a multi-select sweep (spec semantics of
            # ops.encode.mp_encode_from_init's seg_body): position from the
            # sweep-start global snapshot, atom from the CURRENT sharded
            # scores via the usual pmax/pmin/psum winner extraction
            (snapshot, scores_pad, colmax_pad, e_res, done, positions, atoms,
             codes, count, last_t, any_acc) = carry
            lo = j * seg_len
            ids = jnp.arange(npos)
            seg = jnp.where(
                jnp.logical_and(ids >= lo, ids < lo + seg_len),
                snapshot,
                jnp.float32(-1),
            )
            seg_best = jnp.max(seg)
            t = jnp.minimum(jnp.argmax(seg).astype(jnp.int32), jnp.int32(npos - 1))
            col = jax.lax.dynamic_slice(scores_pad, (0, t + (w - 1)), (kl, 1))[:, 0]
            wcol = jnp.abs(col) * weights
            f_loc = jnp.argmax(wcol).astype(jnp.int32)
            v_loc = wcol[f_loc]
            v_glob = jax.lax.pmax(v_loc, axis)
            f_cand = jnp.where(v_loc == v_glob, g0 + f_loc, big).astype(jnp.int32)
            f_glob = jax.lax.pmin(f_cand, axis)
            am_winner = f_cand == f_glob
            s_loc = col[f_loc]
            y = s_loc * inv_scale
            r = jnp.floor(jnp.abs(y) + jnp.float32(0.5)) * jnp.sign(y)
            code_loc = jnp.clip(r, -maxcode, maxcode).astype(jnp.int32)
            packed = jnp.where(
                am_winner,
                jnp.stack([code_loc.astype(jnp.float32), s_loc]),
                jnp.zeros((2,), jnp.float32),
            )
            code_g, s_val = jax.lax.psum(packed, axis)
            code = code_g.astype(jnp.int32)
            guard_ok = jnp.logical_or(last_t < 0, t - last_t >= 2 * w - 1)
            emit = (
                jnp.logical_not(done)
                & (seg_best >= 0)
                & (code != 0)
                & guard_ok
                & (count < num_coefs)
            )
            c_hat = jnp.where(emit, code.astype(jnp.float32) * scale, jnp.float32(0))
            positions = positions.at[count].set(jnp.where(emit, t, positions[count]))
            atoms = atoms.at[count].set(jnp.where(emit, f_glob, atoms[count]))
            codes = codes.at[count].set(jnp.where(emit, code, codes[count]))
            count = count + emit.astype(jnp.int32)
            e_step = jax.lax.optimization_barrier(jnp.float32(2.0) * c_hat * s_val)
            e_sq = jax.lax.optimization_barrier(c_hat * c_hat)
            e_res = jnp.where(emit, (e_res - e_step) + e_sq, e_res)
            gram_rows = jax.lax.dynamic_slice(
                gram_loc, (0, f_glob, 0), (kl, 1, lag)
            )[:, 0, :]
            window = jax.lax.dynamic_slice(scores_pad, (0, t), (kl, lag))
            window = window - jax.lax.optimization_barrier(c_hat * gram_rows)
            scores_pad = jax.lax.dynamic_update_slice(scores_pad, window, (0, t))
            colmax_pad = jax.lax.dynamic_update_slice(
                colmax_pad,
                jnp.max(jnp.abs(window) * weights[:, None], axis=0),
                (t,),
            )
            last_t = jnp.where(emit, t, last_t)
            any_acc = jnp.logical_or(any_acc, emit)
            done = jnp.logical_or(done, jnp.logical_and(emit, e_res <= snr_thr))
            return (snapshot, scores_pad, colmax_pad, e_res, done, positions,
                    atoms, codes, count, last_t, any_acc)

        def sweep_cond(carry):
            (_, _, _, done, _, _, _, count) = carry
            return jnp.logical_and(jnp.logical_not(done), count < num_coefs)

        def sweep_body(carry):
            scores_pad, colmax_pad, e_res, done, positions, atoms, codes, count = carry
            colmax_loc = jax.lax.dynamic_slice(colmax_pad, (w - 1,), (npos,))
            snapshot = jax.lax.pmax(colmax_loc, axis)  # one pmax per sweep
            out = jax.lax.fori_loop(
                0,
                num_select,
                seg_body,
                (snapshot, scores_pad, colmax_pad, e_res, done, positions,
                 atoms, codes, count, jnp.int32(-1), jnp.bool_(False)),
            )
            (_, scores_pad, colmax_pad, e_res, done, positions, atoms, codes,
             count, _, any_acc) = out
            done = jnp.logical_or(done, jnp.logical_not(any_acc))
            return (scores_pad, colmax_pad, e_res, done, positions, atoms,
                    codes, count)

        init = (
            scores_pad,
            colmax_pad,
            e0,
            scale <= 0,
            jnp.zeros((num_coefs,), dtype=jnp.int32),
            jnp.zeros((num_coefs,), dtype=jnp.int32),
            jnp.zeros((num_coefs,), dtype=jnp.int32),
            jnp.int32(0),
        )
        if num_select <= 1:
            (scores_pad, colmax_pad, e_res, done, positions, atoms, codes,
             count), _ = jax.lax.scan(body, init, None, length=num_coefs)
        else:
            (scores_pad, colmax_pad, e_res, done, positions, atoms, codes,
             count) = jax.lax.while_loop(sweep_cond, sweep_body, init)
        return EncodedBlock(
            positions=positions,
            atoms=atoms,
            codes=codes,
            count=count,
            scale=scale,
            energy0=e0,
            energy_res=jnp.maximum(e_res, jnp.float32(0)),
        )

    from ..ops.encode import quantizer_steps

    bank_d = jnp.asarray(bank, jnp.float32)
    init = jax.jit(
        jax.shard_map(
            init_fn,
            mesh=mesh,
            in_specs=(P(), P(axis, None, None)),
            out_specs=(P(axis, None), P(), P()),
            check_vma=False,
        )
    )
    scores0_g, e0, peak = init(x, bank_d)
    scale, inv = quantizer_steps(np.asarray(jax.device_get(peak)), amp_bits)
    loop = jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(axis, None), P(), P(), P(), P(axis, None, None),
                      P(axis, None, None)),
            out_specs=EncodedBlock(
                positions=P(), atoms=P(), codes=P(), count=P(),
                scale=P(), energy0=P(), energy_res=P(),
            ),
            check_vma=False,
        )
    )
    return loop(
        scores0_g, e0, jnp.float32(scale), jnp.float32(inv),
        bank_d, jnp.asarray(gram, jnp.float32),
    )
