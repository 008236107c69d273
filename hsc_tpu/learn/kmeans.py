"""Convolutional dictionary learning — spherical k-means as device matmuls.

Reference parity (SURVEY.md §2 C8, §3.5): `hsc/modeling.py ::
ConvolutionalDictionaryLearner.train` — window extraction (random offsets or
local-energy maxima), init from samples or noise, k-means refinement
(assign via max |correlation|, update centroids, dead-atom reset), algorithm
selected by string kwarg (`'samples'`, `'kmean'`).

Accelerator-first redesign (SURVEY.md §2.3 P8):
  * assignment = one dense ``windows @ centroids^T`` matmul
    (sign-aware: a window can match an atom with either polarity);
  * update = signed one-hot matmul (a segment-sum as a matmul);
  * the whole refinement step is a single jit'd function of (windows,
    centroids) returning (sums, counts) — the *distributed* form runs the same
    step per shard and `psum`s (sums, counts) over the mesh before the
    normalize, keeping replicas bit-identical without a parameter server.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


class KMeansStats(NamedTuple):
    sums: jax.Array  # [K, W*C] signed assignment sums
    counts: jax.Array  # [K] number of windows assigned
    objective: jax.Array  # scalar: sum of |best correlation| (monotone metric)
    best_abs: jax.Array  # [M] per-window |best score| (drives dead-atom reset)


def extract_windows(
    xs: np.ndarray,
    window: int,
    num: int,
    *,
    mode: str = "energy",
    seed: int = 0,
) -> np.ndarray:
    """Extract ``[num, window, C]`` training windows from blocks ``[B, N, C]``.

    Reference: `hsc/modeling.py :: ConvolutionalDictionaryLearner`
    `_extract*Windows` — `mode='random'` samples uniform offsets;
    `mode='energy'` centers windows on local energy maxima (the reference's
    local-maxima strategy), implemented as a vectorized moving-energy argsort
    rather than a Python scan.
    """
    xs = np.asarray(xs, dtype=np.float32)
    if xs.ndim == 2:
        xs = xs[:, :, None]
    b, n, c = xs.shape
    npos = n - window + 1
    if npos <= 0:
        raise ValueError("blocks shorter than window")
    rng = np.random.default_rng(seed)
    if mode == "random":
        bi = rng.integers(0, b, size=num)
        ti = rng.integers(0, npos, size=num)
    elif mode == "energy":
        # moving energy per placement, then sample positions with probability
        # proportional to energy (keeps diversity; pure top-k collapses onto
        # one loud event repeated `num` times)
        e = np.square(xs).sum(axis=2)  # [B, N]
        kernel = np.ones(window, dtype=np.float32)
        env = np.stack([np.convolve(e[i], kernel, mode="valid") for i in range(b)])
        p = env.reshape(-1).astype(np.float64)
        tot = p.sum()
        if tot <= 0:
            p = np.full(p.shape, 1.0 / p.size)
        else:
            p = p / tot
        flat = rng.choice(p.size, size=num, replace=True, p=p)
        bi, ti = np.divmod(flat, npos)
    else:
        raise ValueError(f"unknown extraction mode {mode!r}")
    out = np.zeros((num, window, c), dtype=np.float32)
    for j in range(num):
        out[j] = xs[bi[j], ti[j] : ti[j] + window]
    return out


@functools.partial(jax.jit, static_argnames=())
def kmeans_assign_update(windows: jax.Array, centroids: jax.Array) -> KMeansStats:
    """One assignment pass: per-shard (sums, counts, objective).

    ``windows [M, D]`` (flattened W*C), ``centroids [K, D]`` unit-norm.
    Polarity-invariant: window m contributes ``sign(score) * window`` to its
    best-|score| centroid.  Pure function of its inputs — shard over M and
    psum the outputs for the distributed form (SURVEY.md P8).
    """
    # explicit HIGHEST: a default-precision f32 dot runs in TF32 on GPUs,
    # which would change the learned dictionary with the platform
    scores = jnp.dot(
        windows, centroids.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # [M, K]
    best = jnp.argmax(jnp.abs(scores), axis=1)  # [M]
    bestval = jnp.take_along_axis(scores, best[:, None], axis=1)[:, 0]
    sign = jnp.where(bestval >= 0, jnp.float32(1), jnp.float32(-1))
    onehot = (
        jax.nn.one_hot(best, centroids.shape[0], dtype=jnp.float32)
        * sign[:, None]
    )  # [M, K] signed
    sums = jnp.dot(
        onehot.T, windows, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    counts = jnp.sum(jnp.abs(onehot), axis=0)
    objective = jnp.sum(jnp.abs(bestval))
    return KMeansStats(
        sums=sums, counts=counts, objective=objective, best_abs=jnp.abs(bestval)
    )


# windows with norm below this are "silent" and never used to reseed a dead
# atom (reference dead-atom handling; shared by the local and distributed
# refinement loops)
SILENT_NORM = 1e-6


def dead_reseed_plan(
    dead: jax.Array, keys: jax.Array, valid: jax.Array, m: int
) -> tuple[jax.Array, jax.Array]:
    """Rank dead centroid slots against the worst-represented windows.

    ``keys [M]`` is per-window ``|best score|`` with silent windows parked at
    +inf; ``valid`` is the number of non-silent windows.  Returns
    ``(use [K] bool — reseed this slot, widx [K] — window index per slot)``:
    the lowest dead slot takes the worst window, stable ties.  Shared by
    `kmeans_refine_device` and `parallel.learn.distributed_kmeans` so the
    reseed semantics cannot drift between the local and distributed forms.
    """
    order = jnp.argsort(keys, stable=True)  # worst-represented first
    rank = jnp.cumsum(dead.astype(jnp.int32)) - 1  # per dead slot
    use = jnp.logical_and(dead, rank < jnp.minimum(valid, m))
    widx = order[jnp.clip(rank, 0, m - 1)]  # [K] gather, no scatter
    return use, widx


def apply_reseed(
    new: jax.Array, use: jax.Array, rows: jax.Array
) -> jax.Array:
    """Replace reseeded slots with their unit-normalized window rows."""
    rows = rows / jnp.maximum(
        jnp.linalg.norm(rows, axis=1, keepdims=True), 1e-8
    )
    return jnp.where(use[:, None], rows, new)


@functools.partial(jax.jit, static_argnames=("iterations",))
def kmeans_refine_device(
    windows: jax.Array, cents0: jax.Array, *, iterations: int
) -> tuple[jax.Array, jax.Array]:
    """Device-resident k-means refinement: ``iterations`` full steps
    (assign -> normalize update -> dead-atom reset) under one `lax.scan`,
    returning ``(centroids, objectives[iterations])``.

    One dispatch for the whole training loop — the host-stepped form pays a
    host round trip per iteration (ruinous through a high-RTT device link,
    and a needless sync anywhere).  Same algorithm as the host loop in
    `ConvolutionalDictionaryLearner.train` (reference C8 semantics,
    SURVEY.md §3.5): dead centroids are reseeded from the windows the
    current dictionary represents worst (smallest ``|best score|``),
    skipping near-silent windows, lowest dead slot taking the worst window.
    """
    m = windows.shape[0]
    wnorms = jnp.linalg.norm(windows, axis=1)
    # reset candidates ranked once per step: silent windows sort to the end
    live = wnorms > SILENT_NORM
    valid = jnp.sum(live.astype(jnp.int32))

    def step(cents, _):
        stats = kmeans_assign_update(windows, cents)
        new = normalize_centroids(stats.sums, stats.counts, cents)
        dead = stats.counts <= 0  # [K]
        keys = jnp.where(live, stats.best_abs, jnp.float32(jnp.inf))
        use, widx = dead_reseed_plan(dead, keys, valid, m)
        cents = apply_reseed(new, use, windows[widx])
        return cents, stats.objective

    return jax.lax.scan(step, cents0, None, length=iterations)


def normalize_centroids(
    sums: jax.Array, counts: jax.Array, old: jax.Array, eps: float = 1e-8
) -> jax.Array:
    """Deterministic centroid update: unit-normalized sums; dead atoms
    (count == 0) keep their previous value (reference dead-atom handling —
    reset strategies live in the learner)."""
    norms = jnp.linalg.norm(sums, axis=1, keepdims=True)
    new = sums / jnp.maximum(norms, eps)
    dead = (counts <= 0)[:, None]
    return jnp.where(dead, old, new)


class ConvolutionalDictionaryLearner:
    """Learns one level's filter bank from training sequences.

    Reference: `hsc/modeling.py :: ConvolutionalDictionaryLearner`
    (`k`, `windowSize`, `algorithm` in {'samples', 'kmean'}).
    """

    def __init__(
        self,
        k: int,
        window: int,
        channels: int = 1,
        *,
        algorithm: str = "kmean",
        num_windows: int = 4096,
        iterations: int = 20,
        extraction: str = "energy",
        seed: int = 0,
    ):
        if algorithm not in ("samples", "kmean"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        self.k = int(k)
        self.window = int(window)
        self.channels = int(channels)
        self.algorithm = algorithm
        self.num_windows = int(num_windows)
        self.iterations = int(iterations)
        self.extraction = extraction
        self.seed = int(seed)
        self.objective_history: list[float] = []

    def _init_centroids(self, windows: np.ndarray) -> np.ndarray:
        """Deterministic farthest-point-style init: first window, then
        greedily the window least correlated with the chosen set."""
        m, d = windows.shape
        norms = np.linalg.norm(windows, axis=1)
        order = np.argsort(-norms, kind="stable")
        chosen = [int(order[0])]
        wn = windows / np.maximum(norms[:, None], 1e-8)
        maxcorr = np.abs(wn @ wn[chosen[0]])
        for _ in range(self.k - 1):
            cand = int(np.argmin(maxcorr))
            chosen.append(cand)
            maxcorr = np.maximum(maxcorr, np.abs(wn @ wn[cand]))
        return wn[np.asarray(chosen)].astype(np.float32)

    def train(
        self, xs: np.ndarray, *, mesh=None, mesh_axis: str = "data"
    ) -> np.ndarray:
        """Learn ``[K, W, C]`` filters from blocks ``[B, N, C]``.

        With a `mesh`, windows are sharded over `mesh_axis` and each
        refinement step runs as the psum'd distributed update
        (`parallel.learn.distributed_kmeans_step` — SURVEY.md P8); the
        resulting dictionary is replica-identical.
        """
        windows = extract_windows(
            xs, self.window, self.num_windows, mode=self.extraction, seed=self.seed
        )
        m = windows.shape[0]
        flat = windows.reshape(m, -1)
        if self.algorithm == "samples":
            cents = self._init_centroids(flat)
            self.objective_history = []
            return cents.reshape(self.k, self.window, self.channels)

        cents = jnp.asarray(self._init_centroids(flat))
        self.objective_history = []
        if mesh is not None:
            from ..parallel.learn import distributed_kmeans
            from jax.sharding import NamedSharding, PartitionSpec as P

            shards = int(mesh.shape[mesh_axis])
            pad = (-m) % shards
            if pad:
                # zero windows assign somewhere with score 0 and contribute
                # zero to sums; counts inflate harmlessly (normalize is
                # direction-only), and silent windows are excluded from
                # dead-atom reseeding by the wnorms > 1e-6 filter
                flat = np.concatenate([flat, np.zeros((pad, flat.shape[1]), flat.dtype)])
            wdev = jax.device_put(
                jnp.asarray(flat), NamedSharding(mesh, P(mesh_axis, None))
            )
            cents, objs = distributed_kmeans(
                mesh, wdev, cents, self.iterations, axis=mesh_axis
            )
            cents, objs = jax.device_get((cents, objs))
            self.objective_history = [float(o) for o in objs]
        else:
            # whole refinement loop device-resident: one dispatch, no per-
            # iteration host sync (the host-stepped equivalent is in git
            # history; `kmeans_refine_device` runs the same algorithm)
            cents, objs = kmeans_refine_device(
                jnp.asarray(flat), cents, iterations=self.iterations
            )
            cents, objs = jax.device_get((cents, objs))
            self.objective_history = [float(o) for o in objs]
        return np.asarray(cents).reshape(self.k, self.window, self.channels)
