"""Replaying the port's augmentation draws into the JAX package's
``ops/augment.py``.

The two packages draw from different generators (``torch.Generator`` in the
port, ``jax.random`` keys in JAX), so a JAX recipe is held against the
port's on the same draws: :class:`ReplayAugment` stands in for ``jax`` in
JAX's augment module (``monkeypatch.setattr(jaug, "jax", replay)``) while a
recipe runs or is traced, and JAX's own code crops, flips, jitters and
erases with the numbers the port drew (recorded from the port's
``ops.augment._rand``).
"""
import jax
import jax.numpy as jnp


class ReplayAugment:
    """Stands in for ``jax`` in the JAX package's ``ops/augment.py`` while
    a step is traced: each ``uniform`` and ``bernoulli`` returns the next
    of the port's per-image U[0, 1) draws, which both packages take in the
    same order and map to their ranges alike (``lo + (hi - lo) * u``,
    ``u < p``)."""
    lax, Array = jax.lax, jax.Array

    def __init__(self, uniforms):
        self.random = self
        self._next = iter(uniforms)

    def split(self, key, num=2):
        return [key] * num

    def _u(self, shape):
        u = jnp.asarray(next(self._next).numpy())
        assert u.shape == tuple(shape)
        return u

    def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0,
                maxval=1.0):
        lo, hi = jnp.asarray(minval, dtype), jnp.asarray(maxval, dtype)
        return jnp.maximum(lo, self._u(shape) * (hi - lo) + lo)

    def bernoulli(self, key, p=0.5, shape=()):
        return self._u(shape) < p

    def done(self):
        return next(self._next, None) is None
