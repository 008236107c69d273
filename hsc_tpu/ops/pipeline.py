"""Batch pipelining for the three-stage encode (init -> host steps -> loop).

The host quantizer steps (`ops.encode.quantizer_steps`) cost one device->host
round trip per batch for the tiny peak vector.  This helper overlaps those
round trips with device work: a window of init stages is dispatched first
with async host copies of their peaks, then the loop stages are dispatched as
each peak vector lands — the device stays busy while peaks are in flight.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .encode import encode_init_batched, quantizer_steps
from .route import greedy_loop, greedy_loop_route


def encode_batches_pipelined(
    batches: list[jax.Array],
    bank: jax.Array,
    gram_t: jax.Array,
    *,
    backend: str = "auto",
    window: int | None = 8,
    **settings,
):
    """Encode a list of ``[B, N, C]`` batches; returns a list of EncodedBlock.

    `settings` are the static encode settings (num_coefs, amp_bits, ...).
    `window` bounds how many batches' init score buffers are live at once
    (None = dispatch everything up front — maximal overlap, unbounded
    memory).  `backend` is the `ops.route` choice ('auto' or 'jax').
    """
    defaults = dict(
        amp_bits=16, tolerance_snr=None, singleton_weight=1.0, n_raw=None,
        num_select=1,
    )
    settings = {**defaults, **settings}
    if not batches:
        return []
    k, w = int(bank.shape[0]), int(bank.shape[1])
    route = greedy_loop_route(
        jax.default_backend(), npos=int(batches[0].shape[1]) - w + 1,
        k=k, w=w, num_select=settings["num_select"], backend=backend,
    )
    vloop = greedy_loop(route, settings)

    def loop(s0, e0, sc, iv):
        return vloop(s0, e0, sc, iv, bank, gram_t)

    outs = []
    amp_bits = settings.get("amp_bits", 16)
    n = len(batches)
    step = n if window is None else max(window, 1)
    # Sliding pipeline (no inter-window barrier): at most `window` batches'
    # init score buffers are live (+1 transiently while a loop dispatches);
    # batch i+window's host->device upload and init conv are dispatched
    # right after batch i's loop, so uploads overlap loop compute instead of
    # waiting for the window to drain.  Per-batch arithmetic is untouched —
    # streams are bitwise identical to the barriered form.
    from collections import deque

    inits: deque = deque()
    bi = 0

    def _dispatch_init():
        nonlocal bi
        xb = jax.device_put(batches[bi])  # async upload (no-op if on device)
        s0, e0, peak = encode_init_batched(xb, bank)
        try:
            peak.copy_to_host_async()
        except AttributeError:
            pass
        inits.append((s0, e0, peak))
        bi += 1

    while bi < n and len(inits) < step:
        _dispatch_init()
    while inits:
        s0, e0, peak = inits.popleft()
        scale, inv = quantizer_steps(
            np.asarray(jax.device_get(peak)), amp_bits
        )
        outs.append(loop(s0, e0, jnp.asarray(scale), jnp.asarray(inv)))
        if bi < n:
            _dispatch_init()
    return outs


def encode_hierarchical_batches_pipelined(batches, coder, window: int = 4):
    """Level-pipelined hierarchical corpus encode (SURVEY.md §2.3 P3).

    The serial path (`HierarchicalConvolutionalSparseCoder.encode_batch`
    per batch) stalls the device on one host quantizer round trip per
    (level, batch).  Here every level runs as its own batch pipeline: all
    of a window's init convs are dispatched before any host step, so the
    device encodes batch i while batch i-1's peak vector is in flight, and
    each batch's quantized feature-map hand-off is dispatched
    asynchronously — level k+1 inits start while level k's later batches
    still compute.  Per-block streams are bitwise identical to the serial
    path (same three stage executables, same hand-off jit).

    `window` bounds device memory: at most `window` batches' init score
    buffers are live at once, so arbitrarily large corpora encode in
    bounded memory (overlap is lost only at window boundaries).

    `coder`: a models.coder.HierarchicalConvolutionalSparseCoder.
    `batches`: list of ``[B, N, C]`` device arrays.
    Returns ``outs[level][batch_index]`` EncodedBlocks (device).
    """
    from collections import deque

    cfg = coder.cfg
    n_levels = cfg.num_levels
    outs = [[] for _ in range(n_levels)]
    # Sliding dataflow (no window barrier): each level keeps a FIFO of
    # pending inits; level 0 is fed while earlier batches' loops and
    # hand-offs still run, and deeper levels drain first so hand-off maps
    # are consumed as soon as their peaks land.  At most `window` inits are
    # live per level (the deepest levels stay near-empty by construction).
    # Per-batch executables and their order within each level are unchanged,
    # so streams stay bitwise identical to the serial path.
    pend = [deque() for _ in range(n_levels)]
    bi = 0
    n = len(batches)

    def _push(level, xb):
        mp = coder.coders[level].mp
        if mp.int8_init:
            # xb = (int32 maps, scales) from the integer hand-off
            s0, e0, peak = mp.init_int_batched(*xb)
        else:
            s0, e0, peak = encode_init_batched(xb, mp.bank)
        try:
            peak.copy_to_host_async()
        except AttributeError:
            pass
        pend[level].append((s0, e0, peak))

    def _pop(level):
        mp = coder.coders[level].mp
        s0, e0, peak = pend[level].popleft()
        scale, inv = quantizer_steps(
            np.asarray(jax.device_get(peak)), mp.settings["amp_bits"]
        )
        enc = mp.loop_stage(s0, e0, scale, inv)
        outs[level].append(enc)
        if level + 1 < n_levels:
            if coder.coders[level + 1].mp.int8_init:
                _push(level + 1, (coder.fmap_int_batched(level)(enc), enc.scale))
            else:
                _push(level + 1, coder.fmap_batched(level)(enc))

    w = max(window, 1)
    while bi < n or any(pend):
        if bi < n and len(pend[0]) < w:
            _push(0, jax.device_put(batches[bi]))
            bi += 1
            continue
        # Drain policy: a level's oldest peak is only fetched once that
        # level has a full window buffered (the fetch then hits an init
        # dispatched >= window-1 pops ago, already landed) — fetching a
        # just-dispatched deep init would expose one device round trip per
        # pop.  Otherwise drain shallowest-first, which keeps feeding the
        # deeper buffers.
        lvl = next(
            (k for k in reversed(range(n_levels)) if len(pend[k]) >= w),
            None,
        )
        if lvl is None:
            lvl = next(k for k in range(n_levels) if pend[k])
        _pop(lvl)
    return outs
