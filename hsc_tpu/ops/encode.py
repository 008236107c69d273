"""Device-side greedy convolutional matching pursuit (pure JAX path).

This is the §3.3 hot loop of the reference (`hsc/modeling.py ::
ConvolutionalMatchingPursuit.computeCoefficients`) rebuilt for XLA semantics
(SURVEY.md §7 stage 2):

  * correlation init = one XLA conv (`ops.correlate`),
  * the greedy loop = `lax.scan` over a *static* coefficient budget with a
    `done` mask (dynamic sparsity on a static-shape compiler — SURVEY.md H3),
  * select+subtract = flat argmax + Gram-domain windowed update via
    dynamic_update_slice on a lag-padded score buffer,
  * amplitudes quantized closed-loop inside the iteration, so the emitted
    (position, atom, code) stream is identical to the NumPy oracle's —
    float32 elementwise arithmetic in the same order on both backends.

A CUDA kernel for Hopper implements the same loop (`ops.greedy_cuda`, chosen
by `ops.route`); this module is the portable device path on every platform
and the vmap'able building block.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .correlate import correlate_bank_jax

# Fixed event-buffer axis: encode outputs are padded to the static coefficient
# budget; `count` gives the valid prefix.
MAX_EVENTS_AXIS = 0


class EncodedBlock(NamedTuple):
    """Fixed-shape device encode result (valid prefix = first `count` events)."""

    positions: jax.Array  # int32 [num_coefs]
    atoms: jax.Array  # int32 [num_coefs]
    codes: jax.Array  # int32 [num_coefs]
    count: jax.Array  # int32 scalar
    scale: jax.Array  # float32 scalar
    energy0: jax.Array  # float32 scalar
    energy_res: jax.Array  # float32 scalar


@jax.jit
def encode_init_jax(
    x: jax.Array, bank: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Single-block init correlation + energy + peak, as its OWN jitted
    executable.

    Kept separate from the greedy-loop jit on purpose: the init conv is the
    one fp-order-dependent computation (SURVEY.md H2) and fusing it into a
    larger program can change its reduction by ulps; compiling it standalone
    pins it, and the golden-loop tests inject exactly this function's output
    into the oracle.  Returns (scores0 [K, npos], e0 scalar, peak scalar).
    """
    scores0 = correlate_bank_jax(x, bank)
    e0 = jnp.sum(jnp.square(x.astype(jnp.float32)))
    return scores0, e0, jnp.max(jnp.abs(scores0))


@jax.jit
def encode_init_batched(
    xs: jax.Array, bank: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Batched form of `encode_init_jax`: ``xs [B, N, C]`` ->
    (scores0 [B, K, npos], e0 [B], peak [B]).  The canonical init executable
    shared by every greedy-loop route."""
    scores0 = jax.vmap(correlate_bank_jax, in_axes=(0, None))(xs, bank)
    e0 = jnp.sum(jnp.square(xs.astype(jnp.float32)), axis=(1, 2))
    return scores0, e0, jnp.max(jnp.abs(scores0), axis=(1, 2))


@functools.lru_cache(maxsize=None)
def batched_loop_for(settings_items: tuple):
    """Cached jit(vmap) of the greedy loop for a static-settings tuple.

    Callers must NOT build their own `jax.jit(jax.vmap(partial(...)))` — a
    fresh closure per call site defeats jit's cache and recompiles on every
    call (dict(settings).items() sorted -> the cache key).
    """
    settings = dict(settings_items)
    return jax.jit(
        jax.vmap(
            functools.partial(mp_encode_from_init, **settings),
            in_axes=(0, 0, 0, 0, None, None),
        )
    )


def quantizer_steps(peak, amp_bits: int):
    """Spec quantizer steps from the init peak, computed on the HOST.

    The two divisions are spec-visible (`scale` is written into the stream;
    `inv_scale` drives every code), and jitted backend division is NOT
    reliably exactly rounded (XLA CPU uses a fast reciprocal path, other
    compilers an approximate one) — so the spec defines them as IEEE
    float32 divisions, evaluated in NumPy.  Returns float32 arrays shaped like `peak`.
    """
    peak = np.asarray(peak, dtype=np.float32)
    maxcode = np.float32((1 << (amp_bits - 1)) - 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(peak > 0, (peak / maxcode).astype(np.float32), np.float32(0))
        inv = np.where(peak > 0, (maxcode / peak).astype(np.float32), np.float32(0))
    return scale.astype(np.float32), inv.astype(np.float32)


def mp_encode_jax(
    x: jax.Array,
    bank: jax.Array,
    gram_t: jax.Array,
    *,
    num_coefs: int,
    amp_bits: int = 16,
    tolerance_snr: float | None = None,
    singleton_weight: float = 1.0,
    n_raw: int | None = None,
    num_select: int = 1,
) -> EncodedBlock:
    """Encode one block ``x [N, C]`` against ``bank [K, W, C]``.

    Two jit stages: `encode_init_jax` (fusion-isolated — see its docstring),
    then the greedy loop.  `gram_t` is the *transposed* Gram tensor
    ``gram.transpose(1, 0, 2)`` so that ``gram_t[f][g, d] = G[g, f, d]`` —
    the row gathered per iteration is contiguous.  Must be the exact float32
    array from `MultilevelDictionary.gram` (shared with the oracle).
    """
    scores0, e0, peak = encode_init_jax(x, bank)
    scale, inv_scale = quantizer_steps(jax.device_get(peak), amp_bits)
    return mp_encode_from_init(
        scores0, e0, jnp.float32(scale), jnp.float32(inv_scale), bank, gram_t,
        num_coefs=num_coefs, amp_bits=amp_bits, tolerance_snr=tolerance_snr,
        singleton_weight=singleton_weight, n_raw=n_raw, num_select=num_select,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "num_coefs",
        "amp_bits",
        "tolerance_snr",
        "singleton_weight",
        "n_raw",
        "num_select",
    ),
)
def mp_encode_from_init(
    scores0: jax.Array,
    e0: jax.Array,
    scale: jax.Array,
    inv_scale: jax.Array,
    bank: jax.Array,
    gram_t: jax.Array,
    *,
    num_coefs: int,
    amp_bits: int = 16,
    tolerance_snr: float | None = None,
    singleton_weight: float = 1.0,
    n_raw: int | None = None,
    num_select: int = 1,
) -> EncodedBlock:
    """The greedy loop given precomputed (scores0 [K, Npos], e0) and host-
    computed quantizer steps (`quantizer_steps`) — bitwise deterministic on
    every IEEE backend (SURVEY.md H2; the loop never divides)."""
    k, w, c = bank.shape
    if n_raw is None:
        n_raw = k
    npos = scores0.shape[1]
    lag = 2 * w - 1

    maxcode = jnp.float32((1 << (amp_bits - 1)) - 1)

    weights = jnp.where(
        jnp.arange(k) < n_raw, jnp.float32(1), jnp.float32(singleton_weight)
    )

    if tolerance_snr is not None:
        snr_thr = e0 * jnp.float32(10.0 ** (-tolerance_snr / 10.0))
    else:
        snr_thr = jnp.float32(-1.0)  # never reached (e_res >= 0)

    # Lag-padded score buffer: real position p lives at column p + (W-1); the
    # Gram update window for a pick at p is then the static-size slice
    # [:, p : p + 2W-1] regardless of edge clipping (pad columns absorb the
    # out-of-range lags and are excluded from selection).
    scores_pad = jnp.zeros((k, npos + 2 * w - 2), dtype=jnp.float32)
    scores_pad = jax.lax.dynamic_update_slice(scores_pad, scores0, (0, w - 1))
    # Incrementally-maintained per-position selection cache (spec two-stage
    # argmax: best position by max-over-atoms, then best atom — SURVEY.md
    # §3.3).  max has no rounding, so maintaining only the updated window is
    # bitwise identical to a full recompute, at O(K*(2W-1)) per iteration
    # instead of O(K*Npos).
    # extra tail so multi-select segment slices never clamp (harmless zeros;
    # masked at selection time)
    seg_len_spec = 128 * (-(-npos // (128 * num_select))) if num_select > 1 else 0
    seg_extra = seg_len_spec * num_select - npos if num_select > 1 else 0
    colmax_pad = jnp.zeros((npos + 2 * w - 2 + seg_extra,), dtype=jnp.float32)
    colmax_pad = jax.lax.dynamic_update_slice(
        colmax_pad, jnp.max(jnp.abs(scores0) * weights[:, None], axis=0), (w - 1,)
    )

    def body(carry, _):
        scores_pad, colmax_pad, e_res, done, positions, atoms, codes, count = carry
        colmax_valid = jax.lax.dynamic_slice(colmax_pad, (w - 1,), (npos,))
        t = jnp.argmax(colmax_valid).astype(jnp.int32)  # ties: lowest position
        col = jax.lax.dynamic_slice(scores_pad, (0, t + (w - 1)), (k, 1))[:, 0]
        f = jnp.argmax(jnp.abs(col) * weights).astype(jnp.int32)  # ties: lowest atom
        s = col[f]
        # quantizer spec: round half away from zero (see oracle.mp.mp_encode)
        y = s * inv_scale
        r = jnp.floor(jnp.abs(y) + jnp.float32(0.5)) * jnp.sign(y)
        code = jnp.clip(r, -maxcode, maxcode).astype(jnp.int32)
        emit = jnp.logical_and(jnp.logical_not(done), code != 0)
        c_hat = jnp.where(emit, code.astype(jnp.float32) * scale, jnp.float32(0))

        positions = positions.at[count].set(jnp.where(emit, t, positions[count]))
        atoms = atoms.at[count].set(jnp.where(emit, f, atoms[count]))
        codes = codes.at[count].set(jnp.where(emit, code, codes[count]))
        count = count + emit.astype(jnp.int32)

        # Barriers force multiply-round-add-round (no FMA contraction) so the
        # float32 state trajectory is bitwise the oracle's (SURVEY.md H2).
        e_step = jax.lax.optimization_barrier(jnp.float32(2.0) * c_hat * s)
        e_sq = jax.lax.optimization_barrier(c_hat * c_hat)
        e_res = jnp.where(emit, (e_res - e_step) + e_sq, e_res)
        window = jax.lax.dynamic_slice(scores_pad, (0, t), (k, lag))
        window = window - jax.lax.optimization_barrier(c_hat * gram_t[f])
        scores_pad = jax.lax.dynamic_update_slice(scores_pad, window, (0, t))
        colmax_pad = jax.lax.dynamic_update_slice(
            colmax_pad, jnp.max(jnp.abs(window) * weights[:, None], axis=0), (t,)
        )

        done = jnp.logical_or(
            jnp.logical_or(done, code == 0),
            jnp.logical_and(emit, e_res <= snr_thr),
        )
        return (scores_pad, colmax_pad, e_res, done, positions, atoms, codes, count), None

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
        (scores_pad, colmax_pad, e_res, done, positions, atoms, codes, count), _ = (
            jax.lax.scan(body, init, None, length=num_coefs)
        )
    else:
        # multi-select sweeps (reference `nbBlocks` — see oracle.mp.mp_encode):
        # one candidate per contiguous position segment per sweep, accepted
        # left-to-right with a 2W-1 interference guard so the per-sweep update
        # windows are disjoint.
        seg_len = seg_len_spec
        seg_ids = jnp.arange(seg_len)

        def seg_body(j, carry):
            (snapshot, scores_pad, colmax_pad, e_res, done, positions, atoms,
             codes, count, last_t, any_acc) = carry
            lo = j * seg_len
            # candidates come from the SWEEP-START colmax snapshot (oracle
            # semantics: one selection pass per sweep; intra-sweep updates
            # only affect the next sweep)
            seg = jax.lax.dynamic_slice(snapshot, (w - 1 + lo,), (seg_len,))
            seg = jnp.where(lo + seg_ids < npos, seg, jnp.float32(-1))
            seg_best = jnp.max(seg)
            t = (lo + jnp.argmax(seg)).astype(jnp.int32)
            t = jnp.minimum(t, jnp.int32(npos - 1))  # empty-segment clamp
            col = jax.lax.dynamic_slice(scores_pad, (0, t + (w - 1)), (k, 1))[:, 0]
            f = jnp.argmax(jnp.abs(col) * weights).astype(jnp.int32)
            s = col[f]
            y = s * inv_scale
            r = jnp.floor(jnp.abs(y) + jnp.float32(0.5)) * jnp.sign(y)
            code = jnp.clip(r, -maxcode, maxcode).astype(jnp.int32)
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
            atoms = atoms.at[count].set(jnp.where(emit, f, atoms[count]))
            codes = codes.at[count].set(jnp.where(emit, code, codes[count]))
            count = count + emit.astype(jnp.int32)
            e_step = jax.lax.optimization_barrier(jnp.float32(2.0) * c_hat * s)
            e_sq = jax.lax.optimization_barrier(c_hat * c_hat)
            e_res = jnp.where(emit, (e_res - e_step) + e_sq, e_res)
            window = jax.lax.dynamic_slice(scores_pad, (0, t), (k, lag))
            window = window - jax.lax.optimization_barrier(c_hat * gram_t[f])
            scores_pad = jax.lax.dynamic_update_slice(scores_pad, window, (0, t))
            colmax_pad = jax.lax.dynamic_update_slice(
                colmax_pad, jnp.max(jnp.abs(window) * weights[:, None], axis=0), (t,)
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
            out = jax.lax.fori_loop(
                0,
                num_select,
                seg_body,
                (colmax_pad, scores_pad, colmax_pad, e_res, done, positions,
                 atoms, codes, count, jnp.int32(-1), jnp.bool_(False)),
            )
            (_, scores_pad, colmax_pad, e_res, done, positions, atoms, codes,
             count, _, any_acc) = out
            done = jnp.logical_or(done, jnp.logical_not(any_acc))
            return (scores_pad, colmax_pad, e_res, done, positions, atoms, codes, count)

        (scores_pad, colmax_pad, e_res, done, positions, atoms, codes, count) = (
            jax.lax.while_loop(sweep_cond, sweep_body, init)
        )
    return EncodedBlock(
        positions=positions,
        atoms=atoms,
        codes=codes,
        count=count,
        scale=scale,
        energy0=e0,
        energy_res=jnp.maximum(e_res, jnp.float32(0)),
    )


@functools.partial(jax.jit, static_argnames=("npos", "k"))
def feature_map_jax(
    encoded: EncodedBlock, *, npos: int, k: int
) -> jax.Array:
    """Dense coefficient map ``[Npos, K]`` from device events — bitwise
    `oracle.mp.feature_map_from_events` (exact integer code sums per cell,
    mod 2^32, times the f32 scale; order-free — SURVEY.md §3.4 hand-off)."""
    f_map = feature_map_int_jax(encoded, npos=npos, k=k)
    return f_map.astype(jnp.float32) * encoded.scale.astype(jnp.float32)


def feature_map_int_jax(
    encoded: EncodedBlock, *, npos: int, k: int
) -> jax.Array:
    """The EXACT integer part of `feature_map_jax` (int32 ``[Npos, K]`` code
    sums, mod 2^32 — `oracle.mp.feature_map_int_from_events`); the input the
    int8 level->=1 init (`encode_init_int_batched`) consumes directly.

    One int32 scatter-add of the valid events' codes: integer addition wraps
    mod 2^32 and is exact in any order, so the map is bitwise the oracle's
    on every backend.  (A one-hot int8 matmul form of the same sums was
    miscompiled by XLA:GPU at some shapes — docs/DESIGN.md.)"""
    m = encoded.positions.shape[0]
    mask = jnp.arange(m) < encoded.count
    cz = jnp.where(mask, encoded.codes, 0).astype(jnp.int32)
    return jnp.zeros((npos, k), jnp.int32).at[
        encoded.positions, encoded.atoms
    ].add(cz, mode="drop")


@jax.jit
def encode_init_int_raw(
    m_int: jax.Array,
    prev_scale: jax.Array,
    bank_planes: jax.Array,
    step: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Raw (learned-atom) init score rows of the int8 digit-plane init —
    the dense XLA producer of the `oracle.mp.int8_init_scores` raw-row
    arithmetic.  Returns (raw_scores [B, n_raw, npos] f32, peak_raw [B]);
    `int8_assemble_batched` adds the singleton passthrough rows, the block
    energies, and the combined peak.

    Formulation (all candidates give bitwise-identical integers, so layout
    is a free choice): a SINGLE-SPATIAL-AXIS conv with the four map digits
    folded into the channel dim and the five recombination planes
    T_s = sum_{j+p=s} P_jp emitted as 5K output channels via a zero-stuffed
    (s, j) weight table.  The stuffed table costs 2.5x redundant MACs but
    keeps one dense conv instead of a 2-D digit-axis conv or a grouped one.
    Its time on the H100 is in PERF.md.
    """
    d0 = ((m_int + 128) & 255) - 128
    r = (m_int - d0) >> 8
    d1 = ((r + 128) & 255) - 128
    r2 = (r - d1) >> 8
    d2 = ((r2 + 128) & 255) - 128
    d3 = (r2 - d2) >> 8
    digs = jnp.stack([d0, d1, d2, d3], axis=-1).astype(jnp.int8)  # [B,N,C,4]
    b_sz, n, c = m_int.shape
    k, w = bank_planes.shape[0], bank_planes.shape[1]
    lhs = digs.reshape(b_sz, n, c * 4).transpose(0, 2, 1)  # [B, (c,j), N]
    # rhs[(s,k), (c,j), w] = bank_planes[k, w, c, s-j] for 0 <= s-j <= 1,
    # else 0 — the anti-diagonal sum is baked into the weight table
    planes = bank_planes.transpose(0, 2, 1, 3)  # [K, C, W, 2]
    zero = jnp.zeros((k, c, w), bank_planes.dtype)
    rows = []
    for s in range(5):
        per_j = [
            planes[..., s - j] if 0 <= s - j <= 1 else zero for j in range(4)
        ]
        rows.append(jnp.stack(per_j, axis=2))  # [K, C, 4, W]
    rhs = jnp.concatenate(rows, axis=0).reshape(5 * k, c * 4, w)
    o = jax.lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.int32,
    )  # [B, 5K, npos]
    o = o.reshape(b_sz, 5, k, -1).transpose(0, 2, 3, 1)  # [B, K, npos, 5]
    lo = o[..., 0].astype(jnp.float32) + jnp.float32(256.0) * o[..., 1].astype(
        jnp.float32
    )
    hi = jnp.float32(65536.0) * o[..., 2].astype(jnp.float32) + jnp.float32(
        16777216.0
    ) * o[..., 3].astype(jnp.float32)
    rr = (lo + hi) + jnp.float32(4294967296.0) * o[..., 4].astype(jnp.float32)
    g = prev_scale * step.astype(jnp.float32)
    raw_scores = rr * g[:, None, None]  # [B, n_raw, npos]
    return raw_scores, jnp.max(jnp.abs(raw_scores), axis=(1, 2))


@jax.jit
def int8_assemble_batched(
    raw_scores: jax.Array,
    peak_raw: jax.Array,
    m_int: jax.Array,
    prev_scale: jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Shared epilogue of the int8 init: append the singleton passthrough
    rows (exact scaled-map rows — `oracle.mp.int8_init_scores` docstring),
    compute the block energies, and fold the raw-row peak with the
    singleton peak (max is exact, so the combined value equals a single
    max over the concatenated rows bit-for-bit)."""
    x = m_int.astype(jnp.float32) * prev_scale[:, None, None]
    e0 = jnp.sum(jnp.square(x), axis=(1, 2))
    npos = raw_scores.shape[2]
    sing = x[:, :npos, :].transpose(0, 2, 1)  # [B, C, npos] exact passthrough
    scores0 = jnp.concatenate([raw_scores, sing], axis=1)
    peak = jnp.maximum(peak_raw, jnp.max(jnp.abs(sing), axis=(1, 2)))
    return scores0, e0, peak


def encode_init_int_batched(
    m_int: jax.Array,
    prev_scale: jax.Array,
    bank_planes: jax.Array,
    step: jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Exact int8 digit-plane init for levels >= 1 (hier_init='int8') —
    bitwise `oracle.mp.int8_init_scores` per block, with NO cross-backend
    injection needed (integer accumulation is order-free; the f32
    recombination uses only correctly-rounded conversions and exact
    power-of-two products — see the oracle docstring for the argument).

    ``m_int [B, N, C]`` int32 exact feature maps (`feature_map_int_jax`),
    ``prev_scale [B]`` f32 (the emitting level's quantizer scales),
    ``bank_planes [n_raw, W, C, 2]`` int8 balanced digits of the
    `bank_quantize_int16` codes of the RAW sub-bank, ``step`` f32 scalar
    from the same.  Singleton rows (the trailing C atoms of the augmented
    bank) are exact unit-delta passthroughs of the scaled map — see the
    oracle docstring for why they bypass the quantized bank.

    Composes the dense conv producer (`encode_init_int_raw`) with the
    shared assemble (`int8_assemble_batched`).  Returns (scores0
    [B, K, npos], e0 [B], peak [B]) — the same triple as
    `encode_init_batched`.
    """
    raw_scores, peak_raw = encode_init_int_raw(
        m_int, prev_scale, bank_planes, step
    )
    return int8_assemble_batched(raw_scores, peak_raw, m_int, prev_scale)
