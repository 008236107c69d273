"""Corpus encode/decode runtime: batching, resume journal, metrics.

This is the production path of BASELINE.json configs 2–3: batches of blocks
through the device encoder (`ops.route` picks the greedy loop), host
bit-packing, block-granular journal for idempotent restart (SURVEY.md §5),
per-batch metrics JSONL, and in-order container assembly.
"""

from __future__ import annotations

import os
import re
import struct
import time

import numpy as np

from .config import CodecConfig
from .dictionary import MultilevelDictionary
from .io.bitstream import (
    MAGIC,
    VERSION,
    pack_stream,
    read_index,
    scan_block_offsets,
    unpack_block,
)
from .io.journal import EncodeJournal
from .models.coder import HierarchicalConvolutionalSparseCoder
from .utils.metrics import MetricsLogger


def _journal_name(process_index: int) -> str:
    """Per-process journal file name: process 0 keeps the single-process
    name so existing journals resume unchanged."""
    return "corpus" if process_index == 0 else f"corpus.p{process_index}"


def parse_journal_name(base: str) -> int | None:
    """Inverse of `_journal_name` (kept adjacent so the naming scheme has
    exactly one builder/parser pair): 'corpus' -> 0, 'corpus.pN' -> N,
    anything else -> None."""
    if base == "corpus":
        return 0
    m = re.fullmatch(r"corpus\.p(\d+)", base)
    return int(m.group(1)) if m else None


def journal_fingerprint(
    cfg: CodecConfig, distributed: bool = False,
    target_bps: float | None = None, rate_mode: str = "block",
) -> str:
    """The journal's resume fingerprint: everything that changes journaled
    PAYLOAD bytes beyond the codec config — the distributed representation
    and the constant-bitrate budget.  ONE builder (and one parser below) so
    the writers (CorpusEncoder) and the readers (assemble_container, CLI
    `assemble`) can never diverge again — round 4's first CBR cut built the
    suffix in __init__ only and broke both assembly paths.

    rate_mode='corpus' journals carry ':cbrc=' instead of ':cbr=' — their
    payload BYTES are full-rate TOP-FORM block records (truncation and the
    distributed split happen at container assembly), so the suffix also
    tells assembly what emission work remains.  ':distributed' is still
    recorded (it names the emission form, not the journal bytes, in this
    mode)."""
    s = cfg.to_json()
    if distributed:
        s += ":distributed"
    if target_bps is not None:
        # normalize here, not at call sites: an int-typed rate (natural for
        # whole-number bps) must fingerprint identically to its float form
        tag = "cbrc" if rate_mode == "corpus" else "cbr"
        s += f":{tag}={float(target_bps)!r}"
    return s


def parse_journal_fingerprint(stored: str):
    """Inverse of `journal_fingerprint`:
    (config_json, distributed, target_bps, rate_mode).

    Anchored on the SUFFIX (the config JSON comes first and could in
    principle grow a field containing ':cbr=' as a literal — a substring
    test would mis-split it).  The config JSON always ends in '}', which is
    excluded from the cbr value charset, so the suffix match can never eat
    into the JSON."""
    m = re.search(r"(:distributed)?(?::(cbr|cbrc)=([^:}]+))?$", stored)
    t = m.group(3)
    return (
        stored[: m.start()],
        m.group(1) is not None,
        float(t) if t is not None else None,
        "corpus" if m.group(2) == "cbrc" else "block",
    )


def _prefix_stream(stream, k: int):
    """The first-k-events greedy prefix of a stream (a valid stream itself —
    the prefix property: the first k events of a budget-N encode ARE the
    budget-k encode).  Truncated prefixes carry unknown residual energy —
    zeroed, matching unpacked streams (energies are never serialized)."""
    from .oracle.mp import LevelStream

    if k >= int(stream.positions.shape[0]):
        return stream
    return LevelStream(
        positions=stream.positions[:k],
        atoms=stream.atoms[:k],
        codes=stream.codes[:k],
        scale=np.float32(stream.scale),
        energy0=0.0,
        energy_res=0.0,
    )


def allocate_corpus_prefixes(
    streams: list, budget: int, emit
) -> tuple[list[bytes], list[int]]:
    """Corpus-level constant-bitrate allocation (rate_mode='corpus').

    Chooses per-block greedy-prefix lengths ``k_b`` maximizing explained
    energy subject to ``sum(len(emit(prefix_b(k_b)))) <= budget``.  The
    per-event energy decrement is ``(code*scale)^2`` (greedy MP's own
    acceptance metric), but the per-event gain SEQUENCE is not monotone —
    num_select sweeps accept events in batches whose stored order zigzags
    (measured: ~48% of successive gains increase on the music corpus) — so
    an event-at-a-time frontier greedy cuts blocks at local dips and loses
    the high-gain events behind them (it measured BELOW uniform per-block
    CBR).  Instead, allocation runs on each block's UPPER CONCAVE ENVELOPE
    of cumulative gain vs bytes (the classic R-D allocation): hull
    segments from every block merge in decreasing gain-per-byte order, so
    a dip-then-peak run is taken or dropped as one unit.  Bytes are
    charged at the block's mean packed bytes/event during allocation
    (exact for 'fixed' entropy up to the ceil-to-byte; a few-byte wobble
    for 'rice'), then an exact repair pass enforces the budget on REAL
    packed sizes.  Easy blocks stop early and their spare bytes buy events
    in hard blocks — the corpus-level completion of the per-block CBR in
    `CorpusEncoder._pack_block` (SURVEY.md §2 C9: rate accounting is the
    reference's axis).

    Deterministic from the streams and `emit` alone: float64 gains, ties
    broken by block index — identical allocations on every backend and on
    resume.  Returns (payloads, prefix_lengths), block order preserved.
    """
    nb = len(streams)
    packs: list[dict[int, bytes]] = [{} for _ in range(nb)]

    def size(b: int, k: int) -> int:
        d = packs[b]
        if k not in d:
            d[k] = emit(_prefix_stream(streams[b], k))
        return len(d[k])

    ns = [int(s.positions.shape[0]) for s in streams]
    base = sum(size(b, 0) for b in range(nb))
    if base > budget:
        raise ValueError(
            f"corpus budget {budget} bytes is below the empty-stream "
            f"floor ({base} bytes for {nb} blocks)"
        )
    gains = [
        (s.codes.astype(np.float64) * np.float64(s.scale)) ** 2
        for s in streams
    ]
    # mean bytes/event from one full pack
    est = [
        max((size(b, ns[b]) - size(b, 0)) / ns[b], 1e-9) if ns[b] else 1.0
        for b in range(nb)
    ]
    # upper concave hull of each block's (k, cumulative gain) polyline;
    # segments carry their mean gain-per-byte as the merge key
    segments = []  # (-gain_per_byte, b, k_from, k_to)
    for b in range(nb):
        if not ns[b]:
            continue
        cum = np.concatenate([[0.0], np.cumsum(gains[b])])
        hull = [0]
        for j in range(1, len(cum)):
            while len(hull) >= 2:
                a, m = hull[-2], hull[-1]
                # pop m while it lies on/below chord a->j (keeps slopes
                # strictly decreasing along the hull)
                if (cum[m] - cum[a]) * (j - m) <= (cum[j] - cum[m]) * (m - a):
                    hull.pop()
                else:
                    break
            hull.append(j)
        for a, j in zip(hull, hull[1:]):
            slope = (cum[j] - cum[a]) / ((j - a) * est[b])
            segments.append((-slope, b, a, j))
    segments.sort()

    k = [0] * nb
    spend = float(base)
    for negs, b, a, j in segments:
        if k[b] != a:
            continue  # an earlier boundary cut this block mid-hull
        cost = (j - a) * est[b]
        if spend + cost <= budget:
            k[b] = j
            spend += cost
        else:
            take = int((budget - spend) // est[b])
            if take > 0:
                k[b] = a + take
                spend += take * est[b]

    # exact repair on real packed sizes
    total = sum(size(b, k[b]) for b in range(nb))
    while total > budget:
        # drop the lowest-ratio frontier event
        _, b = min(
            (gains[b][k[b] - 1] / max(est[b], 1e-9), b)
            for b in range(nb)
            if k[b] > 0
        )
        total -= size(b, k[b]) - size(b, k[b] - 1)
        k[b] -= 1
    closed: set[int] = set()
    while len(closed) < 8:  # bounded growth pass (rice wobble is small)
        cands = [
            (-gains[b][k[b]] / max(est[b], 1e-9), b)
            for b in range(nb)
            if k[b] < ns[b] and b not in closed
        ]
        if not cands:
            break
        _, b = min(cands)
        delta = size(b, k[b] + 1) - size(b, k[b])
        if total + delta <= budget:
            total += delta
            k[b] += 1
        else:
            closed.add(b)
    return [packs[b][k[b]] for b in range(nb)], k


def apply_corpus_cbr(
    cfg: CodecConfig,
    records: list[bytes],
    target_bps: float,
    distributed: bool = False,
) -> list[bytes]:
    """Re-emit full-rate TOP-FORM block records under a corpus-level
    constant-bitrate budget (``target_bps * block_size * n_blocks / 8``
    bytes across the whole block region): unpack each record's top stream,
    allocate prefixes corpus-wide (`allocate_corpus_prefixes`), and pack
    the chosen prefixes in the EMISSION form (distributed split applied
    here — the greedy prefix order only exists on the top stream, which is
    why corpus-mode journals store top form).  Format-invisible: the
    output records are ordinary block records."""
    from .oracle.mp import to_distributed

    top = cfg.num_levels - 1
    streams = []
    for rec in records:
        parts, _ = unpack_block(cfg, rec, 0)
        if len(parts) != 1 or parts[0][0] != top:
            raise ValueError(
                "corpus-rate allocation needs top-form records (one "
                f"level-{top} stream per block); got "
                f"{[lv for lv, _ in parts]}"
            )
        streams.append(parts[0][1])

    def emit(stream) -> bytes:
        if distributed and cfg.num_levels > 1:
            parts = to_distributed(cfg, stream)
            return struct.pack("<B", len(parts)) + b"".join(
                pack_stream(cfg, level, s) for level, s in parts
            )
        return struct.pack("<B", 1) + pack_stream(cfg, top, stream)

    budget = int(target_bps * cfg.block_size * len(records) / 8)
    payloads, _ = allocate_corpus_prefixes(streams, budget, emit)
    return payloads


def _join_container(
    cfg: CodecConfig, records, n_blocks: int, index: bool
) -> bytes:
    """Assemble header + block records (+ optional seek-index footer from
    the offsets the assembly already knows — no re-scan)."""
    cfg_json = cfg.to_json().encode()
    parts = [
        MAGIC,
        struct.pack("<BI", VERSION, len(cfg_json)),
        cfg_json,
        struct.pack("<I", n_blocks),
    ]
    off = sum(len(p) for p in parts)
    offsets = np.empty(n_blocks + 1, np.int64)
    for b, rec in enumerate(records):
        offsets[b] = off
        parts.append(rec)
        off += len(rec)
    offsets[n_blocks] = off
    if index:
        from .io.bitstream import _index_footer

        parts.append(_index_footer(offsets))
    return b"".join(parts)


def assemble_container(
    cfg: CodecConfig,
    journal_dir: str,
    n_blocks: int,
    n_processes: int,
    distributed: bool = False,
    index: bool = False,
    target_bps: float | None = None,
    fingerprint: str | None = None,
    rate_mode: str = "block",
) -> bytes:
    """Process-0 container assembly from per-process journals (SURVEY.md
    §2.3 P9: each process journals its own shard under GLOBAL block ids;
    process 0 — with all journals visible on a shared filesystem — emits the
    container in original block order regardless of completion order).
    `index=True` appends the seek-index footer from the offsets the
    assembly already knows.  Absent journal FILES (a process that never
    wrote a block) are skipped rather than created empty in the shared
    directory; their blocks just surface in the missing-ids error.

    `fingerprint`, when given, is the journal resume fingerprint to enforce
    VERBATIM (callers that read it from a journal's .config should pass it
    through rather than rebuilding it from the parsed config — a JSON
    re-serialization round trip is not guaranteed byte-stable across
    versions).

    `rate_mode='corpus'` journals hold full-rate top-form records; the
    corpus-level budget is applied HERE (`apply_corpus_cbr`) — the global
    allocation runs across every process's shard, so multi-host corpora
    get the same corpus-wide rate allocation a single-host encode does."""
    if fingerprint is None:
        fingerprint = journal_fingerprint(cfg, distributed, target_bps, rate_mode)
    journals = [
        EncodeJournal(
            journal_dir,
            name=_journal_name(p),
            config_json=fingerprint,
        )
        for p in range(n_processes)
        if os.path.exists(
            os.path.join(journal_dir, f"{_journal_name(p)}.journal")
        )
    ]
    try:
        owner: dict[int, EncodeJournal] = {}
        for j in journals:
            for bid in j.done_blocks:
                owner.setdefault(bid, j)
        missing = [b for b in range(n_blocks) if b not in owner]
        if missing:
            raise ValueError(
                f"blocks not yet encoded in any journal: {missing[:8]}..."
            )
        records = (owner[b].read(b) for b in range(n_blocks))
        if rate_mode == "corpus" and target_bps is not None:
            records = apply_corpus_cbr(
                cfg, list(records), target_bps, distributed
            )
        return _join_container(cfg, records, n_blocks, index)
    finally:
        for j in journals:
            j.close()


class CorpusEncoder:
    """End-to-end corpus codec around a HierarchicalConvolutionalSparseCoder."""

    def __init__(
        self,
        mld: MultilevelDictionary,
        *,
        backend: str = "auto",
        batch_size: int = 64,
        journal_dir: str | None = None,
        metrics_path: str | None = None,
        process_index: int = 0,
        mesh=None,
        mesh_axis: str = "data",
        distributed: bool = False,
        target_bps: float | None = None,
        rate_mode: str = "block",
    ):
        # mesh: shard encode batches over mesh_axis (data parallelism,
        # parallel/dp.py) — every level of the hierarchy runs under the mesh,
        # with the feature-map hand-off staying sharded on device.
        # distributed: emit the distributed representation (each event stored
        # at the level where its atom is raw — oracle.mp.to_distributed)
        # instead of the top-level-only stream.
        # target_bps: constant-bitrate mode — keep the largest greedy event
        # PREFIXES whose packed payloads fit the byte budget (the prefix
        # property makes any prefix a valid stream: the first k events of a
        # budget-N encode ARE the budget-k encode).  num_coefs stays the
        # quality ceiling; corpora cheaper than the budget are stored whole.
        # rate_mode: how the target_bps budget is allocated —
        #   'block'  — each block independently fits target_bps * block_size
        #              / 8 bytes (hard per-block cap; streaming-friendly);
        #   'corpus' — one corpus-wide budget, allocated across blocks by
        #              marginal-SNR-per-byte (allocate_corpus_prefixes):
        #              easy blocks donate spare bytes to hard ones.  Blocks
        #              journal FULL top-form payloads; truncation (and the
        #              distributed split) happen at container assembly.
        self.mld = mld
        self.cfg: CodecConfig = mld.config
        self.coder = HierarchicalConvolutionalSparseCoder(mld, backend=backend)
        self.batch_size = int(batch_size)
        self.distributed = bool(distributed)
        if target_bps is not None and not target_bps > 0:
            raise ValueError("target_bps must be positive")
        self.target_bps = float(target_bps) if target_bps is not None else None
        if rate_mode not in ("block", "corpus"):
            raise ValueError("rate_mode must be 'block' or 'corpus'")
        self.rate_mode = rate_mode
        self.process_index = int(process_index)
        self.journal = (
            EncodeJournal(
                journal_dir,
                name=_journal_name(self.process_index),
                # CBR changes payload prefixes, so it is part of the resume
                # fingerprint: a journal written at another rate must not be
                # silently extended at this one
                config_json=journal_fingerprint(
                    self.cfg, self.distributed, self.target_bps,
                    self.rate_mode,
                ),
            )
            if journal_dir is not None
            else None
        )
        self.metrics = MetricsLogger(metrics_path, process_index)
        self.dp = None
        self.dp_dec = None
        if mesh is not None:
            from .parallel.dp import (
                DataParallelDecoder,
                HierarchicalDataParallelEncoder,
            )

            self.dp = HierarchicalDataParallelEncoder(
                mesh, self.coder, axis=mesh_axis
            )
            self.dp_dec = DataParallelDecoder(mesh, self.coder, axis=mesh_axis)

    # -- encode -------------------------------------------------------------

    def _pack_block_raw(self, top_stream) -> bytes:
        top = self.cfg.num_levels - 1
        if self.distributed and self.cfg.num_levels > 1:
            from .oracle.mp import to_distributed

            parts = to_distributed(self.cfg, top_stream)
            return struct.pack("<B", len(parts)) + b"".join(
                pack_stream(self.cfg, level, s) for level, s in parts
            )
        return struct.pack("<B", 1) + pack_stream(self.cfg, top, top_stream)

    def _pack_block(self, top_stream) -> tuple[bytes, int]:
        """Pack one block -> (payload, stored event count).  Under
        `target_bps` with rate_mode='block', constant-bitrate truncation
        first: bisect the event-prefix length on the FULL per-block payload
        size (so distributed per-level headers and rice variable-length
        coding are charged exactly).  Packed blobs are memoized per probed
        k, so the chosen prefix is never packed twice.

        rate_mode='corpus' packs the FULL stream in TOP form here (the
        journal/payload representation); the corpus-wide allocation and the
        distributed split run at container assembly (`apply_corpus_cbr`) —
        the greedy prefix order only exists on the top stream."""
        n = int(top_stream.positions.shape[0])
        if self.target_bps is not None and self.rate_mode == "corpus":
            top = self.cfg.num_levels - 1
            return (
                struct.pack("<B", 1) + pack_stream(self.cfg, top, top_stream),
                n,
            )
        if self.target_bps is None:
            return self._pack_block_raw(top_stream), n

        budget = int(self.target_bps * self.cfg.block_size / 8)

        def prefix(k: int):
            return _prefix_stream(top_stream, k)

        blobs: dict[int, bytes] = {}

        def size(k: int) -> int:
            if k not in blobs:
                blobs[k] = self._pack_block_raw(prefix(k))
            return len(blobs[k])

        if size(0) > budget:
            raise ValueError(
                f"target_bps={self.target_bps} is below the empty-stream "
                f"floor ({size(0)} bytes/block > {budget})"
            )
        if size(n) <= budget:
            return blobs[n], n
        lo, hi = 0, n  # invariant: size(lo) <= budget < size(hi)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if size(mid) <= budget:
                lo = mid
            else:
                hi = mid
        # rice sizes can wobble a few bytes per event (delta re-sort,
        # exhaustive-k parameter), so the bisection may converge below the
        # largest feasible prefix; scan upward while the budget still holds
        # (one extra probe in the monotone common case)
        while lo + 1 < n and size(lo + 1) <= budget:
            lo += 1
        return blobs[lo], lo

    def _validate_blocks(self, blocks) -> np.ndarray:
        blocks = np.asarray(blocks, dtype=np.float32)
        if blocks.ndim != 2 or blocks.shape[1] != self.cfg.block_size:
            raise ValueError(
                f"blocks must be [B, {self.cfg.block_size}]; got {blocks.shape}"
            )
        return blocks

    def _emit_batched(
        self,
        enc,
        ids: list[int],
        payloads: dict[int, bytes],
        offset: int,
    ) -> tuple[int, int, list[float]]:
        """Trim a host-side batched EncodedBlock to per-block streams, pack,
        journal under global ids — the one epilogue shared by the pipelined,
        hierarchical, and data-parallel encode paths.  Returns
        (events, payload_bytes, per-block SNRs dB)."""
        from .oracle.mp import LevelStream

        events = 0
        total_bytes = 0
        snrs: list[float] = []
        for j, bid in enumerate(ids):
            n = int(enc.count[j])
            stream = LevelStream(
                positions=np.asarray(enc.positions[j][:n], np.int32),
                atoms=np.asarray(enc.atoms[j][:n], np.int32),
                codes=np.asarray(enc.codes[j][:n], np.int32),
                scale=np.float32(enc.scale[j]),
                energy0=float(enc.energy0[j]),
                energy_res=float(enc.energy_res[j]),
            )
            payload, kept = self._pack_block(stream)
            payloads[bid] = payload
            total_bytes += len(payload)
            # metrics count STORED events; the encoder-tracked SNR belongs
            # to the full encode, so a CBR-truncated block's quality is
            # unknown here (NaN — filtered from the mean) rather than
            # overstated next to the truncated rate
            events += kept
            snrs.append(stream.snr_db() if kept == n else float("nan"))
            if self.journal:
                self.journal.record(bid + offset, payload)
        return events, total_bytes, snrs

    def _log_encode_metrics(
        self, nblk: int, dt: float, events: int, total_bytes: int,
        snrs: list[float], **extra,
    ) -> None:
        self.metrics.log(
            {
                "kind": "encode_batch",
                "blocks": nblk,
                "seconds": dt,
                "mb_per_s": nblk * self.cfg.block_size * 4 / 1e6 / max(dt, 1e-9),
                "events": events,
                "coefs_per_sample": events / max(nblk * self.cfg.block_size, 1),
                # null (not a fabricated 0 dB) when no block has a known
                # SNR — e.g. every block CBR-truncated
                "mean_snr_db": (
                    float(np.mean(finite))
                    if (finite := [v for v in snrs if np.isfinite(v)])
                    else None
                ),
                "bits_per_sample": 8.0 * total_bytes
                / max(nblk * self.cfg.block_size, 1),
                **extra,
            }
        )

    def _compute_payloads(
        self,
        blocks: np.ndarray,
        todo: list[int],
        payloads: dict[int, bytes],
        offset: int = 0,
    ) -> None:
        """Encode `todo` (local indexes into `blocks`) into `payloads`;
        journal entries are recorded under GLOBAL ids ``local + offset``
        (offset != 0 only for multi-host shard encodes)."""
        top = self.cfg.num_levels - 1
        if self.dp is not None:
            self._encode_dp(blocks, todo, payloads, offset)
            return
        if self.cfg.num_levels == 1:
            # single-level corpora run the pipelined 3-stage path (init host
            # round trips overlap device work — ops/pipeline.py)
            self._encode_single_level_pipelined(blocks, todo, payloads, offset)
            return
        # multi-level corpora: level-pipelined batches (SURVEY.md §2.3 P3) —
        # all of a level's init convs are dispatched before any host
        # quantizer step, hand-off maps dispatch asynchronously
        from .ops.pipeline import encode_hierarchical_batches_pipelined

        batches = []
        id_groups = []
        for start in range(0, len(todo), self.batch_size):
            ids = todo[start : start + self.batch_size]
            batches.append(blocks[ids][:, :, None])  # host; uploaded per window
            id_groups.append(ids)
        if not batches:
            return
        t0 = time.perf_counter()
        outs = encode_hierarchical_batches_pipelined(batches, self.coder)
        from .utils import device_get_pipelined

        top_encs = device_get_pipelined(outs[top])
        dt = time.perf_counter() - t0
        events = 0
        total_bytes = 0
        snrs: list[float] = []
        for ids, enc in zip(id_groups, top_encs):
            e, b, sn = self._emit_batched(enc, ids, payloads, offset)
            events += e
            total_bytes += b
            snrs += sn
        self._log_encode_metrics(len(todo), dt, events, total_bytes, snrs)

    def encode(self, blocks: np.ndarray, index: bool = False) -> bytes:
        """Encode ``[B, block_size]`` into the container format; resumable —
        journaled blocks are skipped on restart.  `index=True` appends the
        seek-index footer (docs/FORMAT.md) using the offsets the assembly
        already knows — no re-scan."""
        blocks = self._validate_blocks(blocks)
        nb = blocks.shape[0]
        done = self.journal.done_blocks if self.journal else set()
        todo = [b for b in range(nb) if b not in done]
        payloads: dict[int, bytes] = {}
        self._compute_payloads(blocks, todo, payloads)

        records = (
            payloads[b] if b in payloads else self.journal.read(b)
            for b in range(nb)
        )
        if self.target_bps is not None and self.rate_mode == "corpus":
            full = list(records)
            records = apply_corpus_cbr(
                self.cfg, full, self.target_bps, self.distributed
            )
            self.metrics.log(
                {
                    "kind": "corpus_cbr",
                    "blocks": nb,
                    "budget_bytes": int(
                        self.target_bps * self.cfg.block_size * nb / 8
                    ),
                    "emitted_bytes": sum(len(r) for r in records),
                    "full_bytes": sum(len(r) for r in full),
                }
            )
        return _join_container(self.cfg, records, nb, index)

    # -- multi-host orchestration (SURVEY.md §2.3 P9) -----------------------

    def encode_shard(self, local_blocks: np.ndarray, global_start: int = 0) -> None:
        """Encode a host-local corpus shard, journaling payloads under GLOBAL
        block ids ``global_start + i`` — the per-process half of the
        multi-host story (each process journals its own shard; process 0
        assembles with `assemble_container`).  Requires a journal."""
        if self.journal is None:
            raise ValueError("encode_shard requires a journal_dir")
        blocks = self._validate_blocks(local_blocks)
        done = self.journal.done_blocks
        todo = [
            b for b in range(blocks.shape[0]) if b + global_start not in done
        ]
        self._compute_payloads(blocks, todo, {}, offset=global_start)

    def encode_multihost(
        self,
        local_blocks: np.ndarray,
        n_global: int,
        n_processes: int | None = None,
    ) -> bytes | None:
        """Multi-host corpus encode: every process encodes + journals its
        shard of the canonical block->process split
        (`DataParallelEncoder.multihost_split`; ragged tails allowed), then
        process 0 assembles the container from all journals on the shared
        filesystem.  Returns the container on process 0, None elsewhere.

        `n_processes` defaults to `jax.process_count()`; passing it
        explicitly (with per-encoder `process_index`) exercises the
        shard/assembly protocol single-process (the unit-test harness).
        With one process and process_index 0 this equals `encode`."""
        import jax

        n_proc = jax.process_count() if n_processes is None else int(n_processes)
        if n_proc == 1 and self.process_index == 0:
            return self.encode(local_blocks)
        from .parallel.dp import DataParallelEncoder

        lo, hi = DataParallelEncoder.multihost_split(n_global, n_proc)[
            self.process_index
        ]
        blocks = self._validate_blocks(local_blocks)
        if blocks.shape[0] != hi - lo:
            raise ValueError(
                f"process {self.process_index} must pass blocks [{lo}, {hi}); "
                f"got {blocks.shape[0]}"
            )
        self.encode_shard(blocks, global_start=lo)
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            multihost_utils.sync_global_devices("hsc_tpu_assemble")
        if self.process_index == 0:
            return assemble_container(
                self.cfg,
                os.path.dirname(self.journal._jpath),
                n_global,
                n_proc,
                distributed=self.distributed,
                target_bps=self.target_bps,
                rate_mode=self.rate_mode,
            )
        return None

    def _encode_dp(
        self,
        blocks: np.ndarray,
        todo: list[int],
        payloads: dict[int, bytes],
        offset: int = 0,
    ) -> None:
        """Mesh-sharded encode: super-batches of batch_size x num_shards
        blocks through the HierarchicalDataParallelEncoder — every level runs
        under the mesh, hand-off maps stay sharded (original order
        preserved)."""
        top = self.cfg.num_levels - 1
        super_batch = self.batch_size * self.dp.num_shards
        for start in range(0, len(todo), super_batch):
            ids = todo[start : start + super_batch]
            t0 = time.perf_counter()
            encs = self.dp.encode(blocks[ids])
            enc = encs[top]
            dt = time.perf_counter() - t0
            events, total_bytes, snrs = self._emit_batched(
                enc, ids, payloads, offset
            )
            self._log_encode_metrics(
                len(ids), dt, events, total_bytes, snrs,
                shards=self.dp.num_shards,
            )

    def _encode_single_level_pipelined(
        self,
        blocks: np.ndarray,
        todo: list[int],
        payloads: dict[int, bytes],
        offset: int = 0,
    ) -> None:
        from .ops.pipeline import encode_batches_pipelined

        mp = self.coder.coders[0].mp
        batches = []
        id_groups = []
        for start in range(0, len(todo), self.batch_size):
            ids = todo[start : start + self.batch_size]
            xb = blocks[ids]
            if xb.ndim == 2:
                xb = xb[:, :, None]
            batches.append(xb)  # host; uploaded per pipeline window
            id_groups.append(ids)
        if not batches:
            return
        t0 = time.perf_counter()
        encs = encode_batches_pipelined(
            batches, mp.bank, mp.gram_t, backend=mp.backend, **mp.settings
        )
        from .utils import device_get_pipelined

        encs = device_get_pipelined(encs)
        dt = time.perf_counter() - t0
        events = 0
        total_bytes = 0
        snrs: list[float] = []
        for ids, enc in zip(id_groups, encs):
            e, b, sn = self._emit_batched(enc, ids, payloads, offset)
            events += e
            total_bytes += b
            snrs += sn
        self._log_encode_metrics(len(todo), dt, events, total_bytes, snrs)

    # -- decode -------------------------------------------------------------

    def _check_geometry(self, cfg) -> None:
        # The stream header is the authoritative config (docs/FORMAT.md);
        # only the dictionary GEOMETRY must match this codec — encode-time
        # knobs (budgets, entropy, num_select, tolerance) may differ.
        for field in ("counts", "scales", "block_size"):
            if getattr(cfg, field) != getattr(self.cfg, field):
                raise ValueError(
                    f"stream {field}={getattr(cfg, field)} does not match "
                    f"this dictionary ({getattr(self.cfg, field)})"
                )

    def _decode_device(self, streams, level, mode, rep_bits):
        """One batched device reconstruction — mesh-sharded over 'data' when
        the encoder was built with a mesh (parallel.dp.DataParallelDecoder),
        local otherwise; rows byte-identical either way."""
        dec = self.dp_dec
        if dec is not None:
            return dec.decode_batch_device(
                streams, level=level, mode=mode, rep_bits=rep_bits
            )
        return self.coder.reconstruct_batch_device(
            streams, level=level, mode=mode, rep_bits=rep_bits
        )

    def _decode_chunks(self, cfg, blocks, mode, rep_bits):
        """Yield decoded ``[chunk, block_size]`` arrays in container order —
        the bounded-memory core shared by `decode` and `decode_stream`, for
        EVERY container shape (top-only, distributed, mixed).  Rows are
        byte-identical to per-block `coder.reconstruct` sums in container
        order.

        `blocks` may be a list OR a lazy iterator of per-block
        ``[(level, stream)]`` lists (`_iter_block_records`): blocks are
        consumed one chunk of `batch_size` at a time, so with a lazy source
        (and an mmap'd container) peak memory is O(batch) — unpacked
        events, decoded rows, and <= 4 in-flight device chunks — for
        arbitrarily large corpora.  Each chunk independently takes the
        fast path (one batched device call, the common one-top-stream
        shape), the per-level host-summed path (distributed/mixed), or the
        per-block host loop (exotic same-level-twice shapes); chunks of
        different kinds pipeline through one ordered queue."""
        from collections import deque
        from itertools import islice

        top = cfg.num_levels - 1
        step = max(self.batch_size, 1)
        it = iter(blocks)
        # pending: ("fast", ci, dev) | ("sum", ci, ids, dev)
        pending: deque = deque()
        outs: dict[int, np.ndarray] = {}
        units_left: dict[int, int] = {}
        dispatched: set[int] = set()
        next_yield = 0

        def _drain_one():
            entry = pending.popleft()
            if entry[0] == "fast":
                _, ci, dev = entry
                outs[ci] = np.asarray(dev)[:, :, 0]
            else:
                _, ci, ids, dev = entry
                rec = np.asarray(dev)[:, :, 0]
                for j, b in enumerate(ids):
                    outs[ci][b] += rec[j]
            units_left[ci] -= 1

        def _ready():
            return (
                next_yield in dispatched
                and units_left.get(next_yield, 0) == 0
            )

        def _dispatch(dev):
            try:
                dev.copy_to_host_async()
            except AttributeError:
                pass

        ci = 0
        while True:
            chunk = list(islice(it, step))
            if not chunk:
                break
            if all(len(s) == 1 and s[0][0] == top for s in chunk):
                # common shape: one batched device decode, no host sum
                dev = self._decode_device(
                    [s[0][1] for s in chunk], top, mode, rep_bits
                )
                _dispatch(dev)
                units_left[ci] = 1
                pending.append(("fast", ci, dev))
                if len(pending) >= 4:
                    _drain_one()
            elif all(
                [lv for lv, _ in streams] == sorted({lv for lv, _ in streams})
                for streams in chunk
            ):
                # distributed/mixed (at most one stream per level per
                # block, ascending): one batched device decode per level,
                # host-summed per block in level order — bitwise the
                # per-block loop
                by_level: dict[int, list[tuple[int, object]]] = {}
                for b, streams in enumerate(chunk):
                    for level, stream in streams:
                        by_level.setdefault(level, []).append((b, stream))
                outs[ci] = np.zeros((len(chunk), cfg.block_size), np.float32)
                units_left[ci] = len(by_level)
                for level in sorted(by_level):
                    ids = [b for b, _ in by_level[level]]
                    dev = self._decode_device(
                        [s for _, s in by_level[level]], level, mode, rep_bits
                    )
                    _dispatch(dev)
                    pending.append(("sum", ci, ids, dev))
                    if len(pending) >= 4:
                        _drain_one()
            else:
                # exotic (several streams of one level in one block):
                # per-block host loop in stream order — bounded, not
                # pipelined (nothing writes this shape today)
                out = np.zeros((len(chunk), cfg.block_size), np.float32)
                for b, streams in enumerate(chunk):
                    for level, stream in streams:
                        out[b] += self.coder.reconstruct(
                            stream, level=level, mode=mode, rep_bits=rep_bits
                        )
                outs[ci] = out
                units_left[ci] = 0
            dispatched.add(ci)
            ci += 1
            while _ready():
                yield outs.pop(next_yield)
                next_yield += 1
        while pending:
            _drain_one()
            while _ready():
                yield outs.pop(next_yield)
                next_yield += 1


    def decode_stream(self, blob: bytes, indices=None):
        """Yield decoded blocks ``[block_size]`` — the serving surface:
        bounded memory for arbitrarily large corpora of ANY container shape
        (top-only, --distributed, mixed), device chunks pipelined like
        `decode` (<= 4 in flight), rows byte-identical to `decode`'s.

        `indices` (optional) streams only those blocks, in the order given
        (seek-index footer when present, else one header scan — see
        `decode_blocks`); only the selected payloads are ever unpacked."""
        if indices is not None:
            from .io.bitstream import peek_corpus_header

            cfg, n_blocks = peek_corpus_header(blob)
            self._check_geometry(cfg)
            indices = [int(i) for i in indices]
            for i in indices:
                if not 0 <= i < n_blocks:
                    raise IndexError(
                        f"block {i} out of range [0, {n_blocks})"
                    )
            offsets = read_index(blob)
            if offsets is None or offsets.shape[0] != n_blocks + 1:
                # missing footer, or a stale one (e.g. blocks appended and
                # the header n_blocks bumped without re-indexing): degrade
                # to the header scan, never to a wrong seek (FORMAT.md)
                _, offsets = scan_block_offsets(blob)
            blocks = (
                unpack_block(cfg, blob, int(offsets[i]))[0] for i in indices
            )  # lazy: huge ranges unpack one chunk at a time
        else:
            from .io.bitstream import iter_blocks, peek_corpus_header

            cfg, _n = peek_corpus_header(blob)
            self._check_geometry(cfg)
            # lazy unpack: with an mmap'd container, peak memory is
            # O(batch_size) events + rows for arbitrarily large corpora
            blocks = iter_blocks(blob)
        mode, rep_bits = cfg.decode_mode, cfg.rep_bits
        for chunk in self._decode_chunks(cfg, blocks, mode, rep_bits):
            for row in chunk:
                yield row

    def decode_blocks(self, blob: bytes, indices) -> np.ndarray:
        """Random-access decode: reconstruct ONLY the requested blocks,
        returned as ``[len(indices), block_size]`` in the order given.  Rows
        are byte-identical to the matching rows of `decode` (per-block
        reconstruction is independent of batch grouping).

        Seeks via the optional index footer (`io.append_index`, O(1)) when
        the container carries one; otherwise one header walk
        (`io.scan_block_offsets` — O(corpus headers), no event decoding for
        'fixed' entropy).  Only the selected blocks' payloads are unpacked,
        so serving a few blocks of a huge corpus never materializes it."""
        rows = list(self.decode_stream(blob, indices=list(indices)))
        if not rows:
            return np.zeros((0, self.cfg.block_size), dtype=np.float32)
        return np.stack(rows)

    def decode(self, blob: bytes) -> np.ndarray:
        from .io.bitstream import iter_blocks, peek_corpus_header

        cfg, n_blocks = peek_corpus_header(blob)
        self._check_geometry(cfg)
        t0 = time.perf_counter()
        # the stream header's decode arithmetic is authoritative (mode may
        # differ from this dictionary's config — streams are self-describing)
        mode, rep_bits = cfg.decode_mode, cfg.rep_bits
        blocks = iter_blocks(blob)
        parts = list(self._decode_chunks(cfg, blocks, mode, rep_bits))
        if not parts:  # empty container (zero blocks)
            out = np.zeros((0, cfg.block_size), dtype=np.float32)
        else:
            out = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
        dt = time.perf_counter() - t0
        self.metrics.log(
            {
                "kind": "decode",
                "blocks": n_blocks,
                "seconds": dt,
                "mb_per_s": n_blocks * cfg.block_size * 4 / 1e6 / dt,
            }
        )
        return out


class CorpusReader:
    """Random-access serving handle over a container file.

    Opens the container once (memory-mapped — O(1) resident for any size),
    resolves block offsets once (the seek-index footer when present, one
    header scan otherwise — `decode_blocks` on a raw blob re-scans per
    call), and serves decoded rows on demand:

        reader = CorpusReader("corpus.hsct", mld)
        row = reader[17]                  # one block, [block_size] float32
        for row in reader.rows(100, 164): # a range, chunked + pipelined
            ...

    Rows are byte-identical to `CorpusEncoder.decode`'s.  Thin state —
    offsets (8 bytes/block) plus the codec — so many readers can share one
    mmap'd corpus.
    """

    def __init__(
        self,
        path: str,
        mld: MultilevelDictionary,
        *,
        backend: str = "auto",
        batch_size: int = 64,
        mesh=None,
    ):
        import mmap as _mmap

        from .io.bitstream import _parse_corpus_header

        self._file = open(path, "rb")
        self._data = _mmap.mmap(
            self._file.fileno(), 0, access=_mmap.ACCESS_READ
        )
        self.codec = CorpusEncoder(
            mld, backend=backend, batch_size=batch_size, mesh=mesh
        )
        self.cfg, self.n_blocks, _ = _parse_corpus_header(self._data)
        self.codec._check_geometry(self.cfg)
        offsets = read_index(self._data)
        if offsets is None or offsets.shape[0] != self.n_blocks + 1:
            _, offsets = scan_block_offsets(self._data)
        self._offsets = offsets

    def __len__(self) -> int:
        return self.n_blocks

    def __getitem__(self, i) -> np.ndarray:
        if isinstance(i, slice):
            return np.stack(list(self.rows(*i.indices(self.n_blocks)[:2])))
        i = int(i)
        if i < 0:
            i += self.n_blocks
        return next(iter(self.rows(i, i + 1)))

    def rows(self, start: int = 0, stop: int | None = None):
        """Yield decoded rows [start, stop) — chunked by the codec's
        batch_size, device chunks pipelined, bounded memory."""
        if stop is None:
            stop = self.n_blocks
        start, stop, _ = slice(start, stop).indices(self.n_blocks)
        cfg = self.cfg

        def _blocks():
            for i in range(start, stop):
                yield unpack_block(cfg, self._data, int(self._offsets[i]))[0]

        for chunk in self.codec._decode_chunks(
            cfg, _blocks(), cfg.decode_mode, cfg.rep_bits
        ):
            for row in chunk:
                yield row

    def close(self) -> None:
        self._data.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
