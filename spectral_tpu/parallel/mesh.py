"""Device-mesh construction for tile/sample-sharded rendering.

The reference is single-GPU: its only decomposition is the sequential
host-driven chunk loop (reference rendering/render_manager.cu:3-66). Here
that loop becomes a static 2D ``jax.sharding.Mesh``:

- axis ``tile``   — image rows sharded across devices (the data-parallel
  pixel axis; what the chunk loop serialized, we parallelize).
- axis ``sample`` — samples-per-pixel sharded across devices (the
  embarrassingly-parallel Monte Carlo axis; partial XYZ sums are
  ``psum``-reduced across devices).

Scene + BVH + materials are replicated in device memory (BASELINE north
star); no cross-device traffic happens during tracing — only the final XYZ
psum on the sample axis and the gradient psum on both axes. Every card of
a host reaches every other over NVLink at the same rate, so the mesh shape
follows the algorithm alone: four cards make a (2, 2) mesh.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh

TILE_AXIS = "tile"
SAMPLE_AXIS = "sample"


def factor_devices(n: int) -> tuple[int, int]:
    """Split n devices into (tile, sample) mesh extents.

    Prefers tile-parallelism (zero communication during tracing) and gives
    the sample axis the small factor: for n = 8 -> (4, 2); for primes
    -> (n, 1).
    """
    best = (n, 1)
    for s in range(2, int(math.isqrt(n)) + 1):
        if n % s == 0:
            best = (n // s, s)
    return best


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 2D (tile, sample) mesh over the first ``n_devices`` devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    nt, ns = factor_devices(n)
    arr = np.asarray(devices).reshape(nt, ns)
    return Mesh(arr, (TILE_AXIS, SAMPLE_AXIS))
