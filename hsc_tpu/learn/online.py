"""Online convolutional dictionary learning — minibatch gradient updates.

BASELINE.json config 4: "Online dictionary learning (MP + gradient/k-SVD-
style update) sharded across chips with psum'd updates."  The k-means
alternating path lives in `learn.kmeans`; this is the *online* form:

  per minibatch:  MP-encode the blocks with the current bank (device greedy
  loop, amplitudes quantized and then FROZEN)  ->  one gradient step on the
  reconstruction loss wrt the bank (the loss is linear in the bank given the
  frozen events, so autodiff through the overlap-add is exact)  ->  optax
  update  ->  re-project atoms to unit norm.

Device-native by construction: the encode is the batched device MP, the
gradient is one jit'd `jax.grad`, and the distributed form psums gradients
over the mesh before the optimizer step (replica-identical banks, P8).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax

from ..models.coder import ConvolutionalMatchingPursuit
from ..dictionary import bank_gram


def _reconstruct(bank: jax.Array, positions, atoms, amps, mask, n: int):
    """Differentiable overlap-add of frozen events (linear in `bank`)."""
    k, w, c = bank.shape

    def one_block(pos_b, atom_b, amp_b, mask_b):
        def body(out, i):
            val = jnp.where(mask_b[i], amp_b[i], jnp.float32(0))
            patch = jax.lax.dynamic_slice(out, (pos_b[i], 0), (w, c))
            out = jax.lax.dynamic_update_slice(
                out, patch + val * bank[atom_b[i]], (pos_b[i], 0)
            )
            return out, None

        out0 = jnp.zeros((n, c), dtype=jnp.float32)
        out, _ = jax.lax.scan(body, out0, jnp.arange(pos_b.shape[0]))
        return out

    return jax.vmap(one_block)(positions, atoms, amps, mask)


class OnlineConvolutionalDictionaryLearner:
    """Streaming learner for one level's bank (single- or multi-channel)."""

    def __init__(
        self,
        bank0: np.ndarray,  # [K, W, C] initial (e.g. from 'samples' init)
        *,
        num_coefs: int = 64,
        amp_bits: int = 16,
        optimizer: optax.GradientTransformation | None = None,
        learning_rate: float = 1e-2,
        mesh=None,
        mesh_axis: str = "data",
    ):
        self.bank = jnp.asarray(bank0, dtype=jnp.float32)
        self.num_coefs = int(num_coefs)
        self.amp_bits = int(amp_bits)
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.opt = optimizer or optax.adam(learning_rate)
        self.opt_state = self.opt.init(self.bank)
        self.step_count = 0
        self.loss_history: list[float] = []

        def local_loss_and_grads(bank, xs, positions, atoms, amps, mask, n):
            def loss_fn(b):
                recon = _reconstruct(b, positions, atoms, amps, mask, n)
                return jnp.sum(jnp.square(xs - recon))

            return jax.value_and_grad(loss_fn)(bank)

        @functools.partial(jax.jit, static_argnames=("n", "total"))
        def grad_step(bank, opt_state, xs, positions, atoms, amps, mask, *, n, total):
            if self.mesh is not None:
                # distributed form (SURVEY.md P8): per-shard loss/grad sums,
                # one psum, replica-identical optimizer update
                from jax.sharding import PartitionSpec as P

                def shard_fn(b, x_l, p_l, a_l, am_l, m_l):
                    loss, grads = local_loss_and_grads(b, x_l, p_l, a_l, am_l, m_l, n)
                    return (
                        jax.lax.psum(loss, self.mesh_axis),
                        jax.lax.psum(grads, self.mesh_axis),
                    )

                loss, grads = jax.shard_map(
                    shard_fn,
                    mesh=self.mesh,
                    in_specs=(P(), P(self.mesh_axis), P(self.mesh_axis),
                              P(self.mesh_axis), P(self.mesh_axis),
                              P(self.mesh_axis)),
                    out_specs=(P(), P()),
                    check_vma=False,
                )(bank, xs, positions, atoms, amps, mask)
            else:
                loss, grads = local_loss_and_grads(
                    bank, xs, positions, atoms, amps, mask, n
                )
            loss = loss / jnp.float32(total)
            grads = grads / jnp.float32(total)
            updates, opt_state = self.opt.update(grads, opt_state, bank)
            bank = optax.apply_updates(bank, updates)
            # re-project to unit-norm atoms (the codec invariant)
            norms = jnp.sqrt(
                jnp.sum(jnp.square(bank), axis=(1, 2), keepdims=True)
            )
            bank = bank / jnp.maximum(norms, 1e-8)
            return bank, opt_state, loss

        self._grad_step = grad_step

    def step(self, blocks: np.ndarray) -> float:
        """One online step on a minibatch ``[B, N, C]`` (or ``[B, N]``);
        returns the minibatch reconstruction loss (pre-update)."""
        xs = np.asarray(blocks, dtype=np.float32)
        if xs.ndim == 2:
            xs = xs[:, :, None]
        n = xs.shape[1]
        # 1. sparse-code the minibatch with the CURRENT bank
        gram = bank_gram(np.asarray(self.bank))
        mp = ConvolutionalMatchingPursuit(
            np.asarray(self.bank), gram,
            num_coefs=self.num_coefs, amp_bits=self.amp_bits, backend="jax",
        )
        enc = mp.compute_coefficients_batch(xs)
        amps = enc.codes.astype(jnp.float32) * enc.scale[:, None]
        mask = jnp.arange(enc.positions.shape[1])[None, :] < enc.count[:, None]
        # 2. gradient step on the frozen-event reconstruction loss
        total = int(np.prod(xs.shape))
        self.bank, self.opt_state, loss = self._grad_step(
            self.bank, self.opt_state, jnp.asarray(xs),
            enc.positions, enc.atoms, amps, mask, n=n, total=total,
        )
        self.step_count += 1
        val = float(loss)
        self.loss_history.append(val)
        return val



