"""Device-side correlation: the MP init step as one XLA convolution.

Reference: the dense `innerProducts` init of `hsc/modeling.py ::
ConvolutionalMatchingPursuit.computeCoefficients` (SURVEY.md §3.3) — a
NumPy/SciPy correlate there; here one `lax.conv_general_dilated` with float32
products and accumulation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def correlate_bank_jax(x: jax.Array, bank: jax.Array) -> jax.Array:
    """Valid-mode correlation scores ``[K, Npos]`` (spec layout: atoms
    first, positions contiguous) of ``x [N, C]`` against ``bank [K, W, C]``.

    XLA's conv is cross-correlation (no kernel flip), so this is exactly
    ``scores[k, t] = sum_{u,c} x[t+u, c] * bank[k, u, c]``.
    """
    lhs = x.astype(jnp.float32).T[None]  # [1, C, N]
    rhs = bank.astype(jnp.float32).transpose(0, 2, 1)  # [K, C, W]
    out = jax.lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        # Full float32 (no bf16 passes, no TF32 on a GPU): scores feed the
        # quantizer directly (code = rint(s/scale)), so reduced-precision
        # products would flip codes vs the float32 oracle.  This is a spec
        # requirement, not a tuning.
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[0]  # [K, Npos]
