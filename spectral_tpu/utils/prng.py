"""Counter-based random sampling primitives for the wavefront renderer.

The reference persists one curand XORWOW state per pixel-thread
(reference: rendering/rendering.cu:120-138, seed 1984 + global index). The
replacement is stateless counter-based PRNG: a single root
``jax.random`` key folded with (tile, sample, bounce) counters, which makes
every sample reproducible under any sharding of the pixel/sample axes.

The reference's rejection-sampling loops (math/vec3.cuh:209-246) become
closed-form samplers with *identical output distributions*:
- random_unit_vector: uniform on S^2  == normalized 3D Gaussian
- random_in_unit_disk: uniform in D^2 == (sqrt(u) cos, sqrt(u) sin)
Data-dependent loops would defeat XLA batching; distributions are what the
estimator depends on.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def random_unit_vectors(key: jax.Array, shape: tuple[int, ...]) -> jnp.ndarray:
    """Uniform unit vectors on the sphere, shape [*shape, 3]."""
    v = jax.random.normal(key, (*shape, 3), jnp.float32)
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def random_in_unit_disk(key: jax.Array, shape: tuple[int, ...]) -> jnp.ndarray:
    """Uniform points in the unit disk, shape [*shape, 2]."""
    k1, k2 = jax.random.split(key)
    r = jnp.sqrt(jax.random.uniform(k1, shape, jnp.float32))
    theta = jax.random.uniform(k2, shape, jnp.float32, 0.0, 2.0 * jnp.pi)
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def fold(key: jax.Array, *counters: int | jax.Array) -> jax.Array:
    """Fold a sequence of counters (tile id, sample id, bounce id) into a key."""
    for c in counters:
        key = jax.random.fold_in(key, c)
    return key
