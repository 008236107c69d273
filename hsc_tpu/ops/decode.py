"""Device-side decode: overlap-add reconstruction in stream order.

The bit-exactness surface (`hsc/modeling.py :: ConvolutionalSparseCoder
.reconstruct`, SURVEY.md §3.4): each event adds ``c_hat * bank[f]`` at its
position, sequentially in stream order — the same two float32 IEEE ops per
sample as the NumPy oracle (`hsc_tpu.oracle.mp.mp_decode`), so reconstruction
bytes are identical across backends.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("n",))
def mp_decode_jax(
    positions: jax.Array,
    atoms: jax.Array,
    codes: jax.Array,
    count: jax.Array,
    scale: jax.Array,
    bank: jax.Array,
    *,
    n: int,
) -> jax.Array:
    """Reconstruct ``[N, C]`` from a (padded) event stream.

    `positions/atoms/codes` are the fixed-size buffers from `mp_encode_jax`
    (or unpacked from a bitstream and padded); only the first `count` events
    contribute.
    """
    k, w, c = bank.shape
    amps = codes.astype(jnp.float32) * scale.astype(jnp.float32)
    m = positions.shape[0]
    mask = jnp.arange(m) < count
    # Spec arithmetic is multiply-round-add-round.  The products are
    # materialized *before* the scan: XLA cannot fuse producers into a
    # while-loop body, so the adds inside the loop stay plain fp32 adds (an
    # in-body multiply would get FMA-contracted — single rounding — and flip
    # low bits vs the NumPy oracle).
    prods = jnp.where(mask, amps, jnp.float32(0))[:, None, None] * bank[atoms]

    def body(out, i):
        patch = jax.lax.dynamic_slice(out, (positions[i], 0), (w, c))
        out = jax.lax.dynamic_update_slice(out, patch + prods[i], (positions[i], 0))
        return out, None

    out0 = jnp.zeros((n, c), dtype=jnp.float32)
    out, _ = jax.lax.scan(body, out0, jnp.arange(m))
    return out


@functools.partial(jax.jit, static_argnames=("n",))
def mp_decode_integer_jax(
    positions: jax.Array,
    atoms: jax.Array,
    codes: jax.Array,
    count: jax.Array,
    amp_step: jax.Array,
    rep_q: jax.Array,
    *,
    n: int,
) -> jax.Array:
    """Order-free integer reconstruction (decode_mode='integer', format v2).
    Bitwise-identical to `oracle.mp.mp_decode_integer` on every backend.

    The spec (mod-2^32 integer accumulation of ``code * rep_q`` rows, then
    one f32 scale) is order-free, so instead of the sequential per-event
    overlap-add this is one int32 scatter-add: each valid event's row
    ``code_i * rep_q[atom_i]`` (exact: ``|row| < 2^27``) is added at
    ``positions_i + [0, W)``.  Integer addition wraps mod 2^32 (the spec)
    and is exact in any order, so atomics on a GPU change nothing.  Events
    at index >= count add zero rows.  (A one-hot int8 matmul form of the
    same sums was miscompiled by XLA:GPU at some shapes — docs/DESIGN.md.)

    `amp_step` is the host-computed ``f32(f32(scale) * step)`` per block.
    """
    k, w, c = rep_q.shape
    m = positions.shape[0]
    mask = jnp.arange(m) < count
    cz = jnp.where(mask, codes, 0).astype(jnp.int32)
    rows = cz[:, None, None] * rep_q[atoms]  # [m, w, c] int32
    idx = positions[:, None] + jnp.arange(w, dtype=positions.dtype)  # [m, w]
    out = jnp.zeros((n, c), jnp.int32).at[idx].add(rows, mode="drop")
    return out.astype(jnp.float32) * amp_step.astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("n",))
def mp_decode_integer_batch_jax(
    positions: jax.Array,  # [B, M] i32
    atoms: jax.Array,  # [B, M] i32
    codes: jax.Array,  # [B, M] i32
    count: jax.Array,  # [B] i32
    amp_step: jax.Array,  # [B] f32
    rep_q: jax.Array,  # [K, W, C] i32
    *,
    n: int,
) -> jax.Array:
    """Batched order-free decode ``-> [B, N, C]``; per block identical to
    `mp_decode_integer_jax` (all arithmetic is exact, so batching cannot
    change a single bit)."""
    return jax.vmap(
        lambda p, a, cd, ct, st: mp_decode_integer_jax(
            p, a, cd, ct, st, rep_q, n=n
        )
    )(positions, atoms, codes, count, amp_step)


@functools.partial(jax.jit, static_argnames=("n",))
def mp_decode_batch_jax(
    positions: jax.Array,  # [B, M] i32
    atoms: jax.Array,  # [B, M] i32
    codes: jax.Array,  # [B, M] i32
    count: jax.Array,  # [B] i32
    scale: jax.Array,  # [B] f32
    bank: jax.Array,  # [K, W, C]
    *,
    n: int,
) -> jax.Array:
    """Batched decode ``-> [B, N, C]`` — one jit'd vmap over blocks, same
    stream-order bitwise contract per block as `mp_decode_jax`."""
    return jax.vmap(
        lambda p, a, cd, ct, sc: mp_decode_jax(p, a, cd, ct, sc, bank, n=n)
    )(positions, atoms, codes, count, scale)
