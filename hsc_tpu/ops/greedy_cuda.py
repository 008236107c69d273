"""The greedy MP loop as a CUDA kernel for Hopper, called through the XLA FFI.

`native/greedy_mp.cu` holds the kernel: one thread block per signal block,
the per-position selection cache in shared memory, the working scores in
device memory (one K x (2W-1) window read and written per accept).  It emits
the stream of `ops.encode.mp_encode_from_init` bit for bit: the same float32
operations, each correctly rounded, with FMA contraction disabled at build
time.

The library is compiled with `nvcc` for `sm_90a` on first use, into
`native/build/` under a name keyed by a hash of the source and the flags, so
a changed source can never load a stale binary.  A failed build raises.
Geometries whose selection cache does not fit one block's shared memory are
routed to the XLA loop by `ops.route` before this module is reached.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

from .encode import EncodedBlock

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native")
)
_SOURCE = os.path.join(_NATIVE_DIR, "greedy_mp.cu")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
_TARGET = "hsc_greedy_mp"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

# Threads per block of the kernel (kThreads in the source).
THREADS = 1024
# Dynamic shared memory one block may ask for: the H100's 227 KiB per block
# (232,448 bytes) less 1 KiB for the kernel's static shared arrays.
SHARED_LIMIT = 232448 - 1024


def segment_length(npos: int, num_select: int) -> int:
    """Positions per multi-select segment (the spec's 128-aligned length,
    `oracle.mp.mp_encode`); the whole axis for plain greedy."""
    if num_select <= 1:
        return npos
    return 128 * (-(-npos // (128 * num_select)))


def shared_memory_bytes(npos: int, k: int, w: int, num_select: int) -> int:
    """Dynamic shared memory of one kernel block (mirrors `SharedBytes` in
    the source): the selection cache, the window-refresh partial maxima,
    the selection weights and the per-sweep candidates."""
    lag = 2 * w - 1
    return 4 * (npos + max(lag, THREADS) + k + 2 * max(num_select, 1))


def fits_shared_memory(npos: int, k: int, w: int, num_select: int) -> bool:
    return shared_memory_bytes(npos, k, w, num_select) <= SHARED_LIMIT


def kernel_attributes(
    *, npos: int, num_coefs: int, amp_bits: int, tolerance_snr: float | None,
    num_select: int,
) -> dict:
    """Static FFI attributes of one call.  The SNR threshold factor is
    rounded to float32 exactly as the XLA loop rounds it."""
    return dict(
        num_coefs=np.int32(num_coefs),
        num_select=np.int32(max(num_select, 1)),
        seg_len=np.int32(segment_length(npos, num_select)),
        maxcode=np.float32((1 << (amp_bits - 1)) - 1),
        snr_factor=np.float32(
            10.0 ** (-tolerance_snr / 10.0) if tolerance_snr is not None else 0.0
        ),
        use_snr=np.int32(tolerance_snr is not None),
        max_shared=np.int32(SHARED_LIMIT),
    )


def selection_weights(k: int, n_raw: int, singleton_weight: float) -> np.ndarray:
    """Per-atom selection weights: 1 for learned atoms, `singleton_weight`
    for the singleton passthrough atoms after them."""
    return np.where(
        np.arange(k) < n_raw, np.float32(1), np.float32(singleton_weight)
    ).astype(np.float32)


def library_path() -> str:
    digest = hashlib.sha256()
    with open(_SOURCE, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libhscgreedy-{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the kernel library if this source has not been built yet;
    returns its path.  Raises RuntimeError when nvcc is missing or fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA greedy loop needs the CUDA toolkit")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # build to a per-process name and rename into place (atomic), so a
    # concurrent build never loads a half-written library
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [nvcc, *_NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o", tmp, _SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, path)
    return path


@functools.cache
def _register() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    jax.ffi.register_ffi_target(
        _TARGET, jax.ffi.pycapsule(lib.HscGreedyMp), platform="CUDA"
    )
    return lib  # kept referenced for the life of the process


@functools.partial(
    jax.jit,
    static_argnames=(
        "num_coefs", "amp_bits", "tolerance_snr", "singleton_weight", "n_raw",
        "num_select",
    ),
)
def greedy_loop_cuda(
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
    """Batched greedy loop on precomputed inits: ``scores0 [B, K, npos]``,
    ``e0 / scale / inv_scale [B]`` -> EncodedBlock with a leading batch
    axis — the same contract (and the same bits) as
    `ops.encode.batched_loop_for(settings)`."""
    _register()
    b, k, npos = scores0.shape
    w = int(bank.shape[1])
    if not fits_shared_memory(npos, k, w, num_select):
        raise ValueError(
            f"geometry npos={npos} K={k} W={w} S={num_select} needs "
            f"{shared_memory_bytes(npos, k, w, num_select)} bytes of shared "
            f"memory (limit {SHARED_LIMIT}); route it to the XLA loop"
        )
    weights = selection_weights(k, k if n_raw is None else n_raw, singleton_weight)
    out_types = (
        jax.ShapeDtypeStruct((b, num_coefs), jnp.int32),
        jax.ShapeDtypeStruct((b, num_coefs), jnp.int32),
        jax.ShapeDtypeStruct((b, num_coefs), jnp.int32),
        jax.ShapeDtypeStruct((b,), jnp.int32),
        jax.ShapeDtypeStruct((b,), jnp.float32),
        jax.ShapeDtypeStruct((b, k, npos), jnp.float32),
    )
    positions, atoms, codes, count, e_res, _work = jax.ffi.ffi_call(
        _TARGET, out_types
    )(
        scores0.astype(jnp.float32), e0.astype(jnp.float32),
        scale.astype(jnp.float32), inv_scale.astype(jnp.float32),
        jnp.asarray(gram_t, jnp.float32), jnp.asarray(weights),
        **kernel_attributes(
            npos=npos, num_coefs=num_coefs, amp_bits=amp_bits,
            tolerance_snr=tolerance_snr, num_select=num_select,
        ),
    )
    return EncodedBlock(
        positions=positions, atoms=atoms, codes=codes, count=count,
        scale=scale, energy0=e0, energy_res=e_res,
    )
