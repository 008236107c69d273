"""Data-parallel block encoding — the primary scaling strategy (SURVEY.md
§2.3 P1): signal blocks sharded over the 'data' mesh axis, dictionaries
replicated, per-block greedy MP fully independent, bitstreams gathered on the
host in original block order.

Pipeline per batch (same three stages as the single-device path, sharded):
  1. `encode_init_batched` under the mesh — conv + energies + peaks, sharded
     over 'data';
  2. host quantizer steps from the gathered (tiny) peak vector — the spec's
     IEEE divisions (`ops.encode.quantizer_steps`);
  3. the greedy-loop jit over sharded (scores0, e0, scale, inv).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.coder import ConvolutionalMatchingPursuit
from ..ops.encode import (
    EncodedBlock,
    encode_init_batched,
    mp_encode_from_init,
    quantizer_steps,
)
from ..ops.greedy_cuda import greedy_loop_cuda


class DataParallelEncoder:
    """Shards a batch of blocks across `mesh` axis 'data' and runs the batched
    greedy MP under one pjit; results come back in original block order
    (deterministic gather — SURVEY.md §2.3 P9)."""

    def __init__(self, mesh: Mesh, mp: ConvolutionalMatchingPursuit, axis: str = "data"):
        self.mesh = mesh
        self.mp = mp
        self.axis = axis
        self._data_sharding = NamedSharding(mesh, P(axis, None, None))
        self._vec_sharding = NamedSharding(mesh, P(axis))
        self._repl = NamedSharding(mesh, P())
        settings = dict(mp.settings)
        platform = mesh.devices.flat[0].platform
        xla_loop = jax.vmap(
            functools.partial(mp_encode_from_init, **settings),
            in_axes=(0, 0, 0, 0, None, None),
        )

        def loop(scores0, e0, scale, inv, bank, gram_t):
            # the route is decided at trace time from the scores shape; the
            # CUDA kernel runs on each shard's local blocks inside shard_map
            if mp.route(scores0.shape[2], platform) == "xla":
                return xla_loop(scores0, e0, scale, inv, bank, gram_t)
            return jax.shard_map(
                functools.partial(greedy_loop_cuda, **settings),
                mesh=mesh,
                in_specs=(P(axis, None, None), P(axis), P(axis), P(axis),
                          P(), P()),
                out_specs=EncodedBlock(
                    positions=P(axis, None), atoms=P(axis, None),
                    codes=P(axis, None), count=P(axis), scale=P(axis),
                    energy0=P(axis), energy_res=P(axis),
                ),
                check_vma=False,
            )(scores0, e0, scale, inv, bank, gram_t)

        out_sharding = EncodedBlock(
            positions=NamedSharding(mesh, P(axis, None)),
            atoms=NamedSharding(mesh, P(axis, None)),
            codes=NamedSharding(mesh, P(axis, None)),
            count=self._vec_sharding,
            scale=self._vec_sharding,
            energy0=self._vec_sharding,
            energy_res=self._vec_sharding,
        )
        self._loop = jax.jit(
            loop,
            in_shardings=(
                NamedSharding(mesh, P(axis, None, None)),
                self._vec_sharding,
                self._vec_sharding,
                self._vec_sharding,
                self._repl,
                self._repl,
            ),
            out_shardings=out_sharding,
        )

    @property
    def num_shards(self) -> int:
        return int(self.mesh.shape[self.axis])

    def pad_batch(self, xs: np.ndarray) -> tuple[np.ndarray, int]:
        """Pad block count to a multiple of the shard count (zero blocks
        encode to empty streams and are dropped after gather)."""
        b = xs.shape[0]
        s = self.num_shards
        pad = (-b) % s
        if pad:
            xs = np.concatenate([xs, np.zeros((pad,) + xs.shape[1:], xs.dtype)])
        return xs, b

    def _run(self, arr: jax.Array) -> EncodedBlock:
        scores0, e0, peak = encode_init_batched(arr, self.mp.bank)
        return self._finish(scores0, e0, peak)

    def _finish(self, scores0, e0, peak) -> EncodedBlock:
        scale, inv = quantizer_steps(
            np.asarray(jax.device_get(peak)), self.mp.settings["amp_bits"]
        )
        scale_d = jax.device_put(jnp.asarray(scale), self._vec_sharding)
        inv_d = jax.device_put(jnp.asarray(inv), self._vec_sharding)
        return self._loop(scores0, e0, scale_d, inv_d, self.mp.bank, self.mp.gram_t)

    def encode(self, xs: np.ndarray) -> EncodedBlock:
        """Encode ``[B, N]`` (or ``[B, N, C]``) blocks; B padded to shards."""
        xs = np.asarray(xs, dtype=np.float32)
        if xs.ndim == 2:
            xs = xs[:, :, None]
        padded, b = self.pad_batch(xs)
        arr = jax.device_put(jnp.asarray(padded), self._data_sharding)
        enc = self._run(arr)
        host = jax.device_get(enc)  # gathers shards in block order
        return EncodedBlock(*(np.asarray(v)[:b] for v in host))

    def encode_device(self, arr: jax.Array) -> EncodedBlock:
        """Sharded-in, sharded-out encode of an already-placed ``[B, N, C]``
        device array (B a multiple of the shard count).  Building block for
        the hierarchical DP pipeline, where the inter-level hand-off must stay
        on device."""
        return self._run(arr)

    def encode_device_int(
        self, m_int: jax.Array, prev_scale: jax.Array
    ) -> EncodedBlock:
        """Sharded-in, sharded-out int8-init encode (hier_init='int8') of the
        exact integer hand-off maps ``[B, N, C]`` int32 + their emitting
        level's scales ``[B]`` f32 — the level >= 1 building block of the
        hierarchical DP pipeline.  Shardings propagate through the shared
        `encode_init_int_batched` jit (blocks stay on their shard; the bank
        planes replicate)."""
        scores0, e0, peak = self.mp.init_int_batched(m_int, prev_scale)
        return self._finish(scores0, e0, peak)

    @staticmethod
    def multihost_split(n_global: int, n_processes: int) -> list[tuple[int, int]]:
        """Canonical deterministic block->process assignment: with
        ``nl = ceil(n_global / P)``, process p owns global blocks
        [p*nl, min((p+1)*nl, n_global)).  Every process pads its shard to nl
        blocks, so per-device shard sizes stay uniform (SPMD requirement)
        even when the corpus does not divide evenly — the ragged tail is
        zero-padded and dropped after gather.  Both endpoints clamp to
        n_global, so trailing processes of a short corpus own valid empty
        ranges (never inverted ones)."""
        nl = -(-n_global // max(n_processes, 1))
        return [
            (min(p * nl, n_global), min((p + 1) * nl, n_global))
            for p in range(n_processes)
        ]

    def encode_multihost(self, local_blocks: np.ndarray, n_global: int) -> EncodedBlock:
        """Multi-host SPMD encode (SURVEY.md §2.3 P9): every process passes
        its host-local slice of the corpus per `multihost_split` (ragged
        tails allowed — shards are padded to the uniform per-process count);
        the padded results are allgathered so every host sees the full corpus
        in original block order (process 0 packs the container).

        The allgather makes this the SMALL-CORPUS path: every host receives
        O(corpus-events) bytes.  At scale, use
        `runtime.CorpusEncoder.encode_multihost` instead — each process
        journals only its own shard to disk and process 0 assembles the
        container (no cross-host event traffic at all).

        Single-process this degenerates to `encode`.
        """
        local_blocks = np.asarray(local_blocks, dtype=np.float32)
        if local_blocks.ndim == 2:
            local_blocks = local_blocks[:, :, None]
        if jax.process_count() == 1:
            return self.encode(local_blocks[:n_global])
        from jax.experimental import multihost_utils

        p = jax.process_index()
        lo, hi = self.multihost_split(n_global, jax.process_count())[p]
        if local_blocks.shape[0] != hi - lo:
            raise ValueError(
                f"process {p} must pass blocks [{lo}, {hi}) "
                f"({hi - lo} blocks); got {local_blocks.shape[0]}"
            )
        nl = -(-n_global // jax.process_count())
        if local_blocks.shape[0] < nl:  # ragged tail: zero-pad to uniform
            pad = np.zeros((nl - local_blocks.shape[0],) + local_blocks.shape[1:],
                           local_blocks.dtype)
            local_blocks = np.concatenate([local_blocks, pad])
        arr = jax.make_array_from_process_local_data(
            self._data_sharding, local_blocks
        )
        scores0, e0, peak = encode_init_batched(arr, self.mp.bank)
        peak_global = multihost_utils.process_allgather(peak, tiled=True)
        scale, inv = quantizer_steps(
            np.asarray(peak_global), self.mp.settings["amp_bits"]
        )
        p0 = p * nl
        scale_d = jax.make_array_from_process_local_data(
            self._vec_sharding, scale[p0 : p0 + nl]
        )
        inv_d = jax.make_array_from_process_local_data(
            self._vec_sharding, inv[p0 : p0 + nl]
        )
        enc = self._loop(scores0, e0, scale_d, inv_d, self.mp.bank, self.mp.gram_t)
        host = multihost_utils.process_allgather(enc, tiled=True)
        return EncodedBlock(*(np.asarray(v)[:n_global] for v in host))


class HierarchicalDataParallelEncoder:
    """Data-parallel *hierarchical* corpus encode (SURVEY.md §2.3 P1 + §3.4).

    Every level's three-stage encode (sharded init -> host quantizer steps ->
    sharded greedy loop) runs under the mesh on its block shard, and the
    quantized feature-map hand-off between levels stays sharded on device —
    no gather until all levels finish.  Per-block math is identical to the
    local `HierarchicalConvolutionalSparseCoder.encode_batch` (same init
    executables, same loop jits), so emitted streams are byte-identical."""

    def __init__(self, mesh: Mesh, coder, axis: str = "data"):
        # coder: models.coder.HierarchicalConvolutionalSparseCoder
        self.mesh = mesh
        self.coder = coder
        self.cfg = coder.cfg
        self.axis = axis
        self.levels = [
            DataParallelEncoder(mesh, c.mp, axis=axis) for c in coder.coders
        ]

    @property
    def num_shards(self) -> int:
        return self.levels[0].num_shards

    def _feature_map(self, level: int, enc: EncodedBlock) -> jax.Array:
        """Sharded [B, npos, k] hand-off map; blocks are independent so the
        vmap keeps the batch sharding with no collectives (shared jit:
        models.coder.HierarchicalConvolutionalSparseCoder.fmap_batched)."""
        return self.coder.fmap_batched(level)(enc)

    def encode(self, xs: np.ndarray) -> list[EncodedBlock]:
        """Encode ``[B, block_size]`` blocks; returns one batched (host)
        EncodedBlock per level, trimmed to the original block count."""
        xs = np.asarray(xs, dtype=np.float32)
        if xs.ndim == 2:
            xs = xs[:, :, None]
        padded, b = self.levels[0].pad_batch(xs)
        arr = jax.device_put(
            jnp.asarray(padded), self.levels[0]._data_sharding
        )
        encs: list[EncodedBlock] = []
        arr_int = None  # (int32 maps, scales) under hier_init='int8'
        for level, dp in enumerate(self.levels):
            if dp.mp.int8_init:
                enc = dp.encode_device_int(*arr_int)
            else:
                enc = dp.encode_device(arr)
            encs.append(enc)
            if level + 1 < self.cfg.num_levels:
                if self.levels[level + 1].mp.int8_init:
                    arr_int = (
                        self.coder.fmap_int_batched(level)(enc),
                        enc.scale,
                    )
                else:
                    arr = self._feature_map(level, enc)
        out = []
        for enc in encs:
            host = jax.device_get(enc)  # gathers shards in block order
            out.append(EncodedBlock(*(np.asarray(v)[:b] for v in host)))
        return out


class DataParallelDecoder:
    """Mesh-sharded batch reconstruction (the decode mirror of
    `DataParallelEncoder` — SURVEY.md §2.3 P1): packed stream arrays are
    sharded over the 'data' axis and every shard runs the local XLA decode
    on its blocks under one sharded jit.  Per-block reconstruction is independent of batch grouping,
    so rows are byte-identical to the local decoder's.

    The batch is padded to a multiple of the shard count with empty streams
    (count == 0 decodes to zeros) and trimmed after the gather."""

    def __init__(self, mesh: Mesh, coder, axis: str = "data"):
        # coder: models.coder.HierarchicalConvolutionalSparseCoder
        self.mesh = mesh
        self.coder = coder
        self.axis = axis
        self._mat = NamedSharding(mesh, P(axis, None))
        self._vec = NamedSharding(mesh, P(axis))
        self._jits: dict = {}

    @property
    def num_shards(self) -> int:
        return int(self.mesh.shape[self.axis])

    def _call(self, level: int, mode: str, rep_bits):
        key = (level, mode, rep_bits)
        if key not in self._jits:
            axis, mesh, coder = self.axis, self.mesh, self.coder

            def local(pos, atm, cds, cnt, scl):
                return coder._decode_device_call(
                    pos, atm, cds, cnt, scl, level, mode, rep_bits
                )

            fn = jax.shard_map(
                local,
                mesh=mesh,
                in_specs=(P(axis, None),) * 3 + (P(axis), P(axis)),
                out_specs=P(axis, None, None),
                check_vma=False,
            )
            self._jits[key] = jax.jit(
                fn,
                in_shardings=(self._mat,) * 3 + (self._vec, self._vec),
                out_shardings=NamedSharding(mesh, P(axis, None, None)),
            )
        return self._jits[key]

    def decode_batch_device(self, streams, level=None, mode=None, rep_bits=None):
        """Sharded `reconstruct_batch_device`: returns the device array
        ``[B, block_size, C]`` (global, 'data'-sharded), rows byte-identical
        to the local path's."""
        pos, atm, cds, cnt, scl, level, mode = self.coder._decode_arrays(
            streams, level, mode
        )
        b = pos.shape[0]
        pad = (-b) % self.num_shards
        if pad:
            z = lambda a: np.concatenate(
                [a, np.zeros((pad,) + a.shape[1:], a.dtype)]
            )
            pos, atm, cds, cnt, scl = map(z, (pos, atm, cds, cnt, scl))
        out = self._call(level, mode, rep_bits)(
            jnp.asarray(pos), jnp.asarray(atm), jnp.asarray(cds),
            jnp.asarray(cnt), jnp.asarray(scl),
        )
        return out[:b]
