"""Which implementation of the greedy loop runs, decided in one place.

The greedy MP loop has two implementations that emit the same stream bit
for bit: the XLA loop (`ops.encode.batched_loop_for`, every platform) and the
CUDA kernel for Hopper (`ops.greedy_cuda`).  With ``backend='auto'`` the
choice depends only on what the code can observe — the platform and the
geometry: the CUDA kernel on a GPU when the block's selection cache fits one
thread block's shared memory, else the XLA loop.  ``backend='jax'`` forces
the XLA loop (the reference the kernel is measured and checked against).

Platforms other than ``cpu`` and ``gpu`` are refused rather than guessed at.
Decode has one implementation per mode (`ops.decode`), so it needs no route.
"""

from __future__ import annotations

import functools

from .encode import batched_loop_for
from .greedy_cuda import fits_shared_memory, greedy_loop_cuda

PLATFORMS = ("cpu", "gpu")
BACKENDS = ("auto", "jax")


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    return backend


def greedy_loop_route(
    platform: str, *, npos: int, k: int, w: int, num_select: int,
    backend: str = "auto",
) -> str:
    """'cuda' or 'xla' for one loop call of this geometry on `platform`."""
    check_backend(backend)
    if num_select < 1:
        raise ValueError(f"num_select must be >= 1 (got {num_select})")
    if platform not in PLATFORMS:
        raise ValueError(
            f"no greedy-loop route for platform {platform!r}; "
            f"supported: {PLATFORMS}"
        )
    if backend == "auto" and platform == "gpu" and fits_shared_memory(
        npos, k, w, num_select
    ):
        return "cuda"
    return "xla"


def greedy_loop(route: str, settings: dict):
    """The batched loop callable ``(scores0, e0, scale, inv, bank, gram_t)
    -> EncodedBlock`` of `route` with static `settings` bound."""
    if route == "cuda":
        return functools.partial(greedy_loop_cuda, **settings)
    if route == "xla":
        return batched_loop_for(tuple(sorted(settings.items())))
    raise ValueError(f"unknown route {route!r}")
