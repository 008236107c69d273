"""User-facing coder classes — the device counterparts of the reference API.

Reference parity (SURVEY.md §2 C4–C7):
  * `hsc/modeling.py :: ConvolutionalMatchingPursuit` — here a device greedy
    MP bound to one (bank, Gram) pair, batched over blocks with `vmap`.
  * `hsc/modeling.py :: ConvolutionalSparseCoder` — encode/reconstruct pair.
  * `hsc/modeling.py :: HierarchicalConvolutionalSparseCoder` /
    `HierarchicalConvolutionalMatchingPursuit` — level-by-level pipeline where
    the quantized level-(k-1) coefficient map is the level-k input.

Unlike the reference's per-signal Python orchestration, batches of blocks are
first-class: `encode_batch` is one jit'd vmap'd computation (SURVEY.md §3.3
"batched blocks via vmap"), and the corpus pipeline (encode → host bit-pack →
decode) is the config-2 path of BASELINE.json.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..dictionary import MultilevelDictionary
from ..io import pack_corpus, unpack_corpus
from ..ops.decode import (
    mp_decode_batch_jax,
    mp_decode_integer_jax,
    mp_decode_jax,
)
from ..ops.decode import mp_decode_integer_batch_jax
from ..ops.encode import (
    EncodedBlock,
    encode_init_batched,
    encode_init_int_batched,
    feature_map_int_jax,
    feature_map_jax,
    mp_encode_jax,
    quantizer_steps,
)
from ..ops.route import check_backend, greedy_loop, greedy_loop_route
from ..oracle.mp import LevelStream, balanced_digits, bank_quantize_int16


def _to_level_stream(enc: EncodedBlock) -> LevelStream:
    """Trim a fixed-shape device result to a host LevelStream (valid prefix)."""
    n = int(enc.count)
    return LevelStream(
        positions=np.asarray(enc.positions[:n], dtype=np.int32),
        atoms=np.asarray(enc.atoms[:n], dtype=np.int32),
        codes=np.asarray(enc.codes[:n], dtype=np.int32),
        scale=np.float32(enc.scale),
        energy0=float(enc.energy0),
        energy_res=float(enc.energy_res),
    )


def _pad_stream(stream: LevelStream, capacity: int):
    """Pad a host LevelStream back to fixed device buffers."""
    n = stream.positions.shape[0]
    pos = np.zeros(capacity, np.int32)
    atm = np.zeros(capacity, np.int32)
    cds = np.zeros(capacity, np.int32)
    pos[:n] = stream.positions
    atm[:n] = stream.atoms
    cds[:n] = stream.codes
    return pos, atm, cds, n


class ConvolutionalMatchingPursuit:
    """Greedy convolutional MP on device, bound to one augmented bank.

    Reference: `hsc/modeling.py :: ConvolutionalMatchingPursuit` — its
    `computeCoefficients(X, D, nbNonzeroCoefs, toleranceSnr, singletonWeight)`
    becomes a jit-compiled closure over static settings.

    `backend`: 'auto' lets `ops.route` pick the loop per geometry (the CUDA
    kernel on a GPU where it fits, the XLA loop elsewhere), 'jax' forces the
    XLA loop.  Every route emits the same stream (golden-loop tested).
    """

    def __init__(
        self,
        bank: np.ndarray,
        gram: np.ndarray,
        *,
        num_coefs: int,
        amp_bits: int = 16,
        tolerance_snr: float | None = None,
        singleton_weight: float = 1.0,
        n_raw: int | None = None,
        backend: str = "auto",
        num_select: int = 1,
        int8_init: bool = False,
    ):
        self.bank = jnp.asarray(bank, dtype=jnp.float32)
        # int8 digit-plane init frontend (hier_init='int8', levels >= 1):
        # the bank's int16 quantization and its two balanced int8 digit
        # planes, derived host-side from the bank bytes alone (spec:
        # oracle.mp.bank_quantize_int16)
        self.int8_init = bool(int8_init)
        if self.int8_init:
            # raw sub-bank only: singleton rows are exact passthroughs in
            # the init executable (oracle.mp.int8_init_scores docstring)
            nr = int(n_raw) if n_raw is not None else int(bank.shape[0])
            bank_q, step = bank_quantize_int16(np.asarray(bank)[:nr])
            self.bank_planes = jnp.asarray(balanced_digits(bank_q, 2).astype(np.int8))
            self.bank_step = jnp.float32(step)
        # gram_t[f] = G[:, f, :] — the contiguous per-selection update row.
        self.gram_t = jnp.asarray(
            np.ascontiguousarray(np.asarray(gram).transpose(1, 0, 2)),
            dtype=jnp.float32,
        )
        self.num_coefs = int(num_coefs)
        self.backend = check_backend(backend)
        self.platform = jax.default_backend()
        self.settings = dict(
            num_coefs=int(num_coefs),
            amp_bits=int(amp_bits),
            tolerance_snr=tolerance_snr,
            singleton_weight=float(singleton_weight),
            n_raw=n_raw if n_raw is not None else int(bank.shape[0]),
            num_select=int(num_select),
        )

    def route(self, npos: int, platform: str | None = None) -> str:
        """'cuda' or 'xla': the loop `ops.route` picks for `npos` positions
        on `platform` (default: this process's default backend)."""
        k, w, _ = self.bank.shape
        return greedy_loop_route(
            platform or self.platform, npos=int(npos), k=int(k), w=int(w),
            num_select=self.settings["num_select"], backend=self.backend,
        )

    def compute_coefficients(self, x) -> EncodedBlock:
        """Encode one block ``[N, C]`` (or ``[N]``)."""
        x = jnp.asarray(x, dtype=jnp.float32)
        if x.ndim == 1:
            x = x[:, None]
        if self.route(x.shape[0] - self.bank.shape[1] + 1) == "cuda":
            enc = self.compute_coefficients_batch(x[None])
            return EncodedBlock(*(v[0] for v in enc))
        return mp_encode_jax(x, self.bank, self.gram_t, **self.settings)

    def loop_stage(self, scores0, e0, scale, inv) -> EncodedBlock:
        """Dispatch the greedy-loop stage on a precomputed init (the third
        stage of the init -> host-quantizer -> loop pipeline) through the
        route for this geometry.  Same emitted stream on every route."""
        loop = greedy_loop(self.route(scores0.shape[2]), self.settings)
        return loop(
            scores0, e0, jnp.asarray(scale), jnp.asarray(inv), self.bank, self.gram_t
        )

    def compute_coefficients_batch(self, xs) -> EncodedBlock:
        """Encode ``[B, N, C]`` (or ``[B, N]``) in one jit'd computation."""
        xs = jnp.asarray(xs, dtype=jnp.float32)
        if xs.ndim == 2:
            xs = xs[:, :, None]
        scores0, e0, peak = encode_init_batched(xs, self.bank)
        scale, inv = quantizer_steps(jax.device_get(peak), self.settings["amp_bits"])
        return self.loop_stage(scores0, e0, scale, inv)

    def init_int_batched(self, m_int: jax.Array, prev_scale: jax.Array):
        """The int8 digit-plane init executable bound to this bank
        (hier_init='int8'; requires ``int8_init=True`` at construction).
        ``m_int [B, N, C]`` int32, ``prev_scale [B]`` f32 ->
        (scores0, e0, peak)."""
        return encode_init_int_batched(
            m_int, prev_scale, self.bank_planes, self.bank_step
        )

    def compute_coefficients_batch_int(
        self, m_int: jax.Array, prev_scale: jax.Array
    ) -> EncodedBlock:
        """Encode exact integer feature maps ``[B, N, C]`` (with their
        emitting level's f32 scales) via the int8 init — the level >= 1
        batched entry point under hier_init='int8'."""
        scores0, e0, peak = self.init_int_batched(m_int, prev_scale)
        scale, inv = quantizer_steps(jax.device_get(peak), self.settings["amp_bits"])
        return self.loop_stage(scores0, e0, scale, inv)


class ConvolutionalSparseCoder:
    """Single-level encode/reconstruct pair (reference:
    `hsc/modeling.py :: ConvolutionalSparseCoder.encode / reconstruct`)."""

    def __init__(self, mld: MultilevelDictionary, level: int = 0, backend: str = "auto"):
        self.mld = mld
        self.level = level
        cfg = mld.config
        self.cfg = cfg
        self.mp = ConvolutionalMatchingPursuit(
            mld.augmented(level),
            mld.gram(level),
            num_coefs=cfg.num_coefs[level],
            amp_bits=cfg.amp_bits,
            tolerance_snr=cfg.tolerance_snr,
            singleton_weight=cfg.singleton_weight if level > 0 else 1.0,
            n_raw=cfg.counts[level],
            backend=backend,
            num_select=cfg.num_select,
            int8_init=level > 0 and cfg.hier_init == "int8",
        )

    def encode(self, x) -> LevelStream:
        return _to_level_stream(self.mp.compute_coefficients(x))

    def encode_batch(self, xs) -> list[LevelStream]:
        enc = self.mp.compute_coefficients_batch(xs)
        enc = jax.device_get(enc)
        return [
            LevelStream(
                positions=enc.positions[b][: enc.count[b]].astype(np.int32),
                atoms=enc.atoms[b][: enc.count[b]].astype(np.int32),
                codes=enc.codes[b][: enc.count[b]].astype(np.int32),
                scale=np.float32(enc.scale[b]),
                energy0=float(enc.energy0[b]),
                energy_res=float(enc.energy_res[b]),
            )
            for b in range(enc.count.shape[0])
        ]

    def reconstruct(self, stream: LevelStream, n: int | None = None) -> np.ndarray:
        """Decode on device; byte-identical to the oracle decoder."""
        if n is None:
            n = self.cfg.seq_len(self.level)
        pos, atm, cds, count = _pad_stream(stream, max(self.mp.num_coefs, 1))
        out = mp_decode_jax(
            jnp.asarray(pos),
            jnp.asarray(atm),
            jnp.asarray(cds),
            jnp.int32(count),
            jnp.float32(stream.scale),
            self.mp.bank,
            n=n,
        )
        return np.asarray(out)


class HierarchicalConvolutionalSparseCoder:
    """Multi-level encode/reconstruct over a MultilevelDictionary.

    Reference: `hsc/modeling.py :: HierarchicalConvolutionalSparseCoder` (and
    the hierarchical MP it wraps).  encode returns one LevelStream per level;
    the top stream is the compressed representation (singleton passthrough
    keeps bare lower-level structure alive — SURVEY.md §3.4).
    """

    def __init__(self, mld: MultilevelDictionary, backend: str = "auto"):
        self.mld = mld
        self.cfg = mld.config
        self.coders = [
            ConvolutionalSparseCoder(mld, level, backend=backend)
            for level in range(self.cfg.num_levels)
        ]
        # decode bank = signal-space representations of the top augmented atoms
        top = self.cfg.num_levels - 1
        self._rep_banks = {
            k: jnp.asarray(mld.representations(k)[:, :, None]) for k in range(top + 1)
        }
        # quantized representation banks for decode_mode='integer', cached
        # per (level, rep_bits) — streams are self-describing, so a decoder
        # may need a rep_bits different from this dictionary's config
        self._rep_q_banks: dict[tuple[int, int], tuple[jax.Array, np.float32]] = {}
        self._fmap_batched = {}
        self._fmap_int_batched = {}

    def fmap_batched(self, level: int):
        """Cached jit'd vmap of the level -> level+1 hand-off map — the ONE
        construction shared by the serial, level-pipelined, and
        data-parallel hierarchical paths."""
        if level not in self._fmap_batched:
            self._fmap_batched[level] = jax.jit(
                jax.vmap(
                    functools.partial(
                        feature_map_jax,
                        npos=self.cfg.num_positions(level),
                        k=self.mld.num_atoms(level),
                    )
                )
            )
        return self._fmap_batched[level]

    def fmap_int_batched(self, level: int):
        """Integer-map variant of `fmap_batched` (hier_init='int8'): the
        level -> level+1 hand-off WITHOUT the f32 scale multiply — the int8
        init consumes the exact int32 map plus the scale vector directly."""
        if level not in self._fmap_int_batched:
            self._fmap_int_batched[level] = jax.jit(
                jax.vmap(
                    functools.partial(
                        feature_map_int_jax,
                        npos=self.cfg.num_positions(level),
                        k=self.mld.num_atoms(level),
                    )
                )
            )
        return self._fmap_int_batched[level]

    def _rep_q(self, level: int, rep_bits: int):
        key = (level, int(rep_bits))
        if key not in self._rep_q_banks:
            from ..oracle.mp import rep_quantize

            q, step = rep_quantize(
                self.mld.representations(level)[:, :, None], rep_bits
            )
            self._rep_q_banks[key] = (jnp.asarray(q), step)
        return self._rep_q_banks[key]

    # -- encode ------------------------------------------------------------

    def encode(self, x) -> list[LevelStream]:
        return [ _to_level_stream(e) for e in self._encode_device(jnp.asarray(x)) ]

    def _encode_device(self, x: jax.Array) -> list[EncodedBlock]:
        cfg = self.cfg
        if x.ndim == 1:
            x = x[:, None]
        out = []
        seq = x  # f32 input (level 0 / hier_init='f32' hand-off)
        seq_int = None  # exact int32 map + its scale (hier_init='int8')
        for level in range(cfg.num_levels):
            mp = self.coders[level].mp
            if mp.int8_init:
                m_int, prev_scale = seq_int
                enc_b = mp.compute_coefficients_batch_int(
                    m_int[None], prev_scale[None]
                )
                enc = EncodedBlock(*(v[0] for v in enc_b))
            else:
                enc = mp.compute_coefficients(seq)
            out.append(enc)
            if level + 1 < cfg.num_levels:
                if self.coders[level + 1].mp.int8_init:
                    seq_int = (
                        feature_map_int_jax(
                            enc,
                            npos=cfg.num_positions(level),
                            k=self.mld.num_atoms(level),
                        ),
                        enc.scale,
                    )
                else:
                    seq = feature_map_jax(
                        enc,
                        npos=cfg.num_positions(level),
                        k=self.mld.num_atoms(level),
                    )
        return out

    def encode_batch(self, xs) -> list[list[LevelStream]]:
        """Encode ``[B, N]`` blocks; returns per-block lists of per-level
        streams.  Each level runs as one jit'd vmap over the whole batch."""
        cfg = self.cfg
        xs = jnp.asarray(xs, dtype=jnp.float32)
        if xs.ndim == 2:
            xs = xs[:, :, None]
        levels: list[EncodedBlock] = []
        seq = xs
        seq_int = None  # (int32 maps, scales) under hier_init='int8'
        for level in range(cfg.num_levels):
            mp = self.coders[level].mp
            if mp.int8_init:
                enc = mp.compute_coefficients_batch_int(*seq_int)
            else:
                enc = mp.compute_coefficients_batch(seq)
            levels.append(enc)
            if level + 1 < cfg.num_levels:
                if self.coders[level + 1].mp.int8_init:
                    seq_int = (self.fmap_int_batched(level)(enc), enc.scale)
                else:
                    seq = self.fmap_batched(level)(enc)
        levels = [jax.device_get(e) for e in levels]
        nb = levels[0].count.shape[0]
        out = []
        for b in range(nb):
            out.append(
                [
                    LevelStream(
                        positions=e.positions[b][: e.count[b]].astype(np.int32),
                        atoms=e.atoms[b][: e.count[b]].astype(np.int32),
                        codes=e.codes[b][: e.count[b]].astype(np.int32),
                        scale=np.float32(e.scale[b]),
                        energy0=float(e.energy0[b]),
                        energy_res=float(e.energy_res[b]),
                    )
                    for e in levels
                ]
            )
        return out

    # -- decode ------------------------------------------------------------

    def reconstruct(
        self,
        top_stream: LevelStream,
        level: int | None = None,
        mode: str | None = None,
        rep_bits: int | None = None,
    ) -> np.ndarray:
        """Signal-space reconstruction of a top-level stream (the bit-exact
        surface; equals `hsc_tpu.oracle.hierarchical_decode` for
        mode='ordered', `oracle.mp.mp_decode_integer` for mode='integer').

        `mode`/`rep_bits` default to this dictionary's config; decoders of
        self-describing streams pass the stream header's values."""
        cfg = self.cfg
        if level is None:
            level = cfg.num_levels - 1
        if mode is None:
            mode = cfg.decode_mode
        cap = max(cfg.num_coefs[level], 1, int(top_stream.positions.shape[0]))
        pos, atm, cds, count = _pad_stream(top_stream, cap)
        if mode == "integer":
            rep_q, step = self._rep_q(level, rep_bits or cfg.rep_bits)
            amp_step = np.float32(np.float32(top_stream.scale) * step)
            out = mp_decode_integer_jax(
                jnp.asarray(pos),
                jnp.asarray(atm),
                jnp.asarray(cds),
                jnp.int32(count),
                jnp.float32(amp_step),
                rep_q,
                n=cfg.block_size,
            )
        else:
            out = mp_decode_jax(
                jnp.asarray(pos),
                jnp.asarray(atm),
                jnp.asarray(cds),
                jnp.int32(count),
                jnp.float32(top_stream.scale),
                self._rep_banks[level],
                n=cfg.block_size,
            )
        return np.asarray(out)[:, 0]

    def reconstruct_batch(
        self,
        streams: list[LevelStream],
        level: int | None = None,
        mode: str | None = None,
        rep_bits: int | None = None,
    ) -> np.ndarray:
        """Batched reconstruction ``[B, block_size]`` — one jit'd vmap, per
        block byte-identical to `reconstruct`."""
        return np.asarray(
            self.reconstruct_batch_device(
                streams, level=level, mode=mode, rep_bits=rep_bits
            )
        )[:, :, 0]

    def reconstruct_batch_device(
        self,
        streams: list[LevelStream],
        level: int | None = None,
        mode: str | None = None,
        rep_bits: int | None = None,
    ):
        """`reconstruct_batch` without the host sync: returns the device
        array ``[B, block_size, C]`` so corpus decoders can overlap one
        chunk's device->host copy with the next chunk's compute."""
        pos, atm, cds, cnt, scl, level, mode = self._decode_arrays(
            streams, level, mode
        )
        return self._decode_device_call(
            jnp.asarray(pos), jnp.asarray(atm), jnp.asarray(cds),
            jnp.asarray(cnt), jnp.asarray(scl), level, mode, rep_bits,
        )

    def _decode_arrays(self, streams, level=None, mode=None):
        """Pack a list of LevelStreams into fixed-shape decode arrays
        ``(pos, atm, cds, cnt, scl)`` (NumPy, [B, cap]/[B]) plus the
        resolved (level, mode) — the host half of `reconstruct_batch_device`,
        shared with the mesh-sharded decoder (`parallel.dp`)."""
        cfg = self.cfg
        if level is None:
            level = cfg.num_levels - 1
        if mode is None:
            mode = cfg.decode_mode
        need = max([1] + [int(s.positions.shape[0]) for s in streams])
        cap = max(cfg.num_coefs[level], 1)
        if need > cap:
            # streams longer than this coder's budget (the container is
            # self-describing — e.g. encoded with a larger --num-coefs):
            # bucket the capacity to the next power of two so corpus chunks
            # with varying max lengths reuse one compiled shape instead of
            # paying a device recompile per chunk
            cap = 1 << (need - 1).bit_length()
        nb = len(streams)
        pos = np.zeros((nb, cap), np.int32)
        atm = np.zeros((nb, cap), np.int32)
        cds = np.zeros((nb, cap), np.int32)
        cnt = np.zeros((nb,), np.int32)
        scl = np.zeros((nb,), np.float32)
        for b, s in enumerate(streams):
            p, a, c, n = _pad_stream(s, cap)
            pos[b], atm[b], cds[b], cnt[b] = p, a, c, n
            scl[b] = np.float32(s.scale)
        return pos, atm, cds, cnt, scl, level, mode

    def _decode_device_call(self, pos, atm, cds, cnt, scl, level, mode, rep_bits):
        """Device decode from packed arrays -> ``[B, block_size, C]`` —
        traceable (callable under shard_map for the mesh-sharded decoder;
        per-block arithmetic is independent of batch grouping, so sharded
        and local calls are byte-identical per block)."""
        cfg = self.cfg
        if mode == "integer":
            rep_q, step = self._rep_q(level, rep_bits or cfg.rep_bits)
            amp_step = (scl * jnp.float32(step)).astype(jnp.float32)
            return mp_decode_integer_batch_jax(
                pos, atm, cds, cnt, amp_step, rep_q, n=cfg.block_size
            )
        return mp_decode_batch_jax(
            pos, atm, cds, cnt, scl, self._rep_banks[level], n=cfg.block_size
        )

    # -- corpus pipeline (config 2/3 of BASELINE.json) ----------------------

    def encode_corpus(self, blocks: np.ndarray) -> bytes:
        """Encode ``[B, block_size]`` and bit-pack top-level streams."""
        top = self.cfg.num_levels - 1
        encoded = self.encode_batch(blocks)
        return pack_corpus(self.cfg, [[(top, streams[top])] for streams in encoded])

    def decode_corpus(self, blob: bytes) -> np.ndarray:
        """Decode a packed corpus back to ``[B, block_size]`` float32."""
        cfg, blocks = unpack_corpus(blob)
        if cfg != self.cfg:
            raise ValueError("corpus config does not match this coder")
        out = np.zeros((len(blocks), cfg.block_size), dtype=np.float32)
        for b, streams in enumerate(blocks):
            for level, stream in streams:
                out[b] += self.reconstruct(stream, level=level)
        return out
