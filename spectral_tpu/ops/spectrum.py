"""Batched spectral sampling primitives.

Vectorized, differentiable equivalents of the reference's
per-ray scalar loops:

- ``spectrum_interp``  <- reference spectrum/spectrum.cu:11-22
- ``hero_wavelengths`` <- reference spectrum/spectrum.cu:31-48
  (Wilkie et al. 2014 hero-wavelength spectral sampling)
- ``spectrum_to_xyz``  <- reference color/color.cu:88-104

Everything here is shape-polymorphic over leading batch dimensions and safe
to ``vmap`` / ``jit`` / differentiate. Wavelength axes are kept as the
trailing axis; XLA lays batches across VPU lanes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.constants import (
    LAMBDA_MAX,
    LAMBDA_MIN,
    N_CIE_SAMPLES,
    N_RAY_WAVELENGTHS,
    cie_xyz,
)


def _select_lerp(lo_of, hi_of, cell, w, n):
    """Unrolled select-chain lerp over a small static table (a gather is
    the alternative; which is faster on the GPU is open, ROADMAP S-queue).
    ``lo_of(k)``/``hi_of(k)`` give the table values at cell k / k+1,
    broadcastable to cell's shape."""
    lo = jnp.zeros_like(w)
    hi = jnp.zeros_like(w)
    for k in range(n - 1):
        sel = cell == k
        lo = jnp.where(sel, lo_of(k), lo)
        hi = jnp.where(sel, hi_of(k), hi)
    return (1.0 - w) * lo + w * hi


def spectrum_interp(spd: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """Piecewise-linear lookup of a uniformly sampled SPD at wavelength(s).

    ``spd`` has shape [..., n_samples] over [LAMBDA_MIN, LAMBDA_MAX];
    ``lam`` broadcasts against ``spd[..., 0]``. Matches the reference's
    clamped-offset lerp semantics (spectrum/spectrum.cu:11-22): the integer
    cell index is clamped to [0, n-2] while the fractional weight is NOT
    clamped, so out-of-range wavelengths extrapolate linearly exactly like
    the CUDA code.

    Differentiable in both ``spd`` and ``lam``.
    """
    n = spd.shape[-1]
    x = (lam - LAMBDA_MIN) * ((n - 1) / (LAMBDA_MAX - LAMBDA_MIN))
    cell = jnp.clip(x.astype(jnp.int32), 0, n - 2)
    w = x - cell.astype(x.dtype)
    if spd.ndim == cell.ndim + 1:
        return _select_lerp(
            lambda k: spd[..., k], lambda k: spd[..., k + 1], cell, w, n
        )
    return _select_lerp(lambda k: spd[k], lambda k: spd[k + 1], cell, w, n)


def spectrum_interp_shared(spd: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """Lookup a single shared SPD [n] at a batch of wavelengths [...]."""
    n = spd.shape[-1]
    x = (lam - LAMBDA_MIN) * ((n - 1) / (LAMBDA_MAX - LAMBDA_MIN))
    cell = jnp.clip(x.astype(jnp.int32), 0, n - 2)
    w = x - cell.astype(x.dtype)
    return _select_lerp(lambda k: spd[k], lambda k: spd[k + 1], cell, w, n)


def hero_wavelengths(key: jax.Array, batch_shape: tuple[int, ...], n_lambdas: int = N_RAY_WAVELENGTHS) -> jnp.ndarray:
    """Sample hero wavelengths: [*batch, n_lambdas], hero at index 0.

    Hero lambda ~ U[LAMBDA_MIN, LAMBDA_MAX); the remaining n-1 wavelengths
    are equally spaced with wraparound into the visible range
    (reference: spectrum/spectrum.cu:31-48). The per-step wrap in the CUDA
    loop is equivalent to a single modulo because step < range.
    """
    span = LAMBDA_MAX - LAMBDA_MIN
    step = span / float(n_lambdas)
    hero = jax.random.uniform(key, batch_shape, jnp.float32, LAMBDA_MIN, LAMBDA_MAX)
    offs = jnp.arange(n_lambdas, dtype=jnp.float32) * step
    lam = hero[..., None] + offs
    # wrap: the reference wraps strictly-greater-than LAMBDA_MAX values
    return jnp.where(lam > LAMBDA_MAX, lam - span, lam)


def spectrum_to_xyz(
    wavelengths: jnp.ndarray,
    power: jnp.ndarray,
    n_valid: jnp.ndarray,
) -> jnp.ndarray:
    """Riemann-sum a sampled ray spectrum into CIE XYZ.

    wavelengths, power: [..., W]; n_valid: [...] integer count of leading
    valid wavelengths (the reference's ``valid_wavelengths`` prefix counter,
    ray/ray.cuh:20; integration at color/color.cu:88-104 with
    delta_lambda = (LAMBDA_MAX - LAMBDA_MIN) / W).

    Returns [..., 3] XYZ. Differentiable in ``power`` and ``wavelengths``;
    ``n_valid`` is discrete (no gradient).
    """
    w = wavelengths.shape[-1]
    delta = (LAMBDA_MAX - LAMBDA_MIN) / float(w)
    idx = jnp.arange(w, dtype=jnp.int32)
    mask = (idx < n_valid[..., None]).astype(power.dtype)
    weighted = power * mask * delta
    # [3, 95] CIE curves sampled at each ray wavelength -> [..., W, 3]
    resp = jnp.stack(
        [spectrum_interp_shared(cie_xyz[i], wavelengths) for i in range(3)],
        axis=-1,
    )
    return jnp.einsum("...w,...wc->...c", weighted, resp)
