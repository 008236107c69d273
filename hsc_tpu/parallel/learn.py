"""Distributed dictionary learning step — SURVEY.md §2.3 P8.

Each shard accumulates (assignment sums, counts, objective) over its local
windows; one `psum` over the mesh axis; the normalize-update then runs
identically on every replica — bit-identical dictionaries everywhere with no
parameter server.  This is the sharded counterpart of
`hsc/modeling.py :: ConvolutionalDictionaryLearner.train`'s k-means loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..learn.kmeans import (
    SILENT_NORM,
    apply_reseed,
    dead_reseed_plan,
    kmeans_assign_update,
    normalize_centroids,
)


def distributed_kmeans_step(
    mesh: Mesh, windows: jax.Array, centroids: jax.Array, axis: str = "data"
):
    """One sharded refinement step.

    `windows [M, D]` sharded over `axis`; `centroids [K, D]` replicated.
    Returns (new_centroids [K, D] replicated, objective scalar).
    """

    def step(w, c):
        stats = kmeans_assign_update(w, c)
        sums = jax.lax.psum(stats.sums, axis)
        counts = jax.lax.psum(stats.counts, axis)
        obj = jax.lax.psum(stats.objective, axis)
        return normalize_centroids(sums, counts, c), obj

    fn = jax.jit(
        jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(P(axis, None), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )
    )
    return fn(windows, centroids)


def distributed_kmeans(
    mesh: Mesh,
    windows: jax.Array,
    centroids0: jax.Array,
    iterations: int,
    axis: str = "data",
):
    """Full sharded k-means refinement — one dispatch for all iterations.

    The whole loop (assign -> psum -> normalize -> dead-atom reset) runs as a
    `lax.scan` inside one `shard_map`: no per-iteration host sync, and the
    same dead-atom semantics as the local `kmeans_refine_device` (dead slots
    reseed from the globally worst-represented non-silent windows).  The
    cross-shard row fetch is a local one-hot matmul + `psum` (never an XLA
    scatter).  Every value after a `psum` is replicated computation, so the
    dictionaries stay bit-identical on all replicas.

    Returns (centroids [K, D] replicated, objectives [iterations]).
    """
    shards = int(mesh.shape[axis])
    m_total = windows.shape[0]
    if m_total % shards:
        raise ValueError("windows must divide the mesh axis (pad first)")

    def body(w, c0):
        my = jax.lax.axis_index(axis)
        mloc = w.shape[0]
        m = mloc * shards
        wnorms_l = jnp.linalg.norm(w, axis=1)
        live_l = wnorms_l > SILENT_NORM
        valid = jax.lax.psum(jnp.sum(live_l.astype(jnp.int32)), axis)

        def step(c, _):
            stats = kmeans_assign_update(w, c)
            sums = jax.lax.psum(stats.sums, axis)
            counts = jax.lax.psum(stats.counts, axis)
            obj = jax.lax.psum(stats.objective, axis)
            new = normalize_centroids(sums, counts, c)
            dead = counts <= 0  # [K]
            keys_l = jnp.where(live_l, stats.best_abs, jnp.float32(jnp.inf))
            # global window order is shard-major (axis-0 contiguous shards),
            # so the tiled all_gather reproduces the unsharded key vector
            keys = jax.lax.all_gather(keys_l, axis, tiled=True)  # [M]
            use, widx = dead_reseed_plan(dead, keys, valid, m)
            lidx = widx - my * mloc
            own = jnp.logical_and(lidx >= 0, lidx < mloc)
            onehot = (
                jax.nn.one_hot(
                    jnp.clip(lidx, 0, mloc - 1), mloc, dtype=jnp.float32
                )
                * own[:, None]
            )  # [K, mloc]
            rows = jax.lax.psum(
                jnp.dot(
                    onehot, w, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST,
                ),
                axis,
            )  # [K, D] replicated
            c = apply_reseed(new, use, rows)
            return c, obj

        return jax.lax.scan(step, c0, None, length=iterations)

    fn = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(axis, None), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )
    )
    return fn(jnp.asarray(windows), jnp.asarray(centroids0))
