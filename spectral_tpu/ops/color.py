"""sRGB <-> CIE XYZ conversion and gamma handling, batched and differentiable.

Batched equivalents of the reference's per-pixel scalar color pipeline
(reference: color/color.cu):

- ``srgb_gamma_expand`` / ``srgb_gamma_compress`` <- color.cu:8-22
- ``srgb_to_xyz`` / ``xyz_to_srgb``               <- color.cu:24-41
- ``expand_srgb``                                  <- color.cu:43-49

All functions take arrays shaped [..., 3] and broadcast over leading axes.
The 3x3 matrix products run as a single einsum so XLA can fuse them into the
surrounding elementwise work.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils.constants import d65_srgb_to_xyz, d65_xyz_to_srgb


def srgb_gamma_expand(v: jnp.ndarray) -> jnp.ndarray:
    """Inverse sRGB gamma (encoded -> linear); reference color.cu:8-13."""
    return jnp.where(v < 0.04045, v / 12.92, jnp.power(jnp.maximum((v + 0.055) / 1.055, 0.0), 2.4))


def srgb_gamma_compress(v: jnp.ndarray) -> jnp.ndarray:
    """Forward sRGB gamma with the reference's clamping (color.cu:15-22).

    Matches the CUDA nested-ternary exactly: negative -> 0, linear segment
    below 0.0031308, power segment with exponent 0.416666 (the reference's
    truncated 1/2.4) below 1, saturate at 1.
    """
    v_safe = jnp.maximum(v, 1e-30)  # pow grad safety; selected away below
    powseg = 1.055 * jnp.power(v_safe, 0.416666) - 0.055
    out = jnp.where(v < 0.0031308, 12.92 * v, jnp.where(v < 1.0, powseg, 1.0))
    return jnp.where(v < 0.0, 0.0, out)


def srgb_to_xyz(srgb: jnp.ndarray, matrix: jnp.ndarray | None = None) -> jnp.ndarray:
    """Encoded sRGB [..., 3] -> XYZ [..., 3] (reference color.cu:24-33)."""
    m = d65_srgb_to_xyz if matrix is None else matrix
    return jnp.einsum("ij,...j->...i", m, srgb_gamma_expand(srgb))


def xyz_to_srgb(xyz: jnp.ndarray, matrix: jnp.ndarray | None = None) -> jnp.ndarray:
    """XYZ [..., 3] -> gamma-encoded sRGB [..., 3] (reference color.cu:35-41)."""
    m = d65_xyz_to_srgb if matrix is None else matrix
    return srgb_gamma_compress(jnp.einsum("ij,...j->...i", m, xyz))


def expand_srgb(srgb01: jnp.ndarray) -> jnp.ndarray:
    """[0,1] floats -> [0,255] floats with the reference's int truncation
    (color.cu:43-49: ``float(int(v * 255.99f))``)."""
    return jnp.trunc(srgb01 * 255.99)


def to_uint8(srgb01: jnp.ndarray) -> jnp.ndarray:
    """Final framebuffer quantization (reference frame_buffer.cuh:31-37
    truncating float->uchar cast after expand_sRGB)."""
    return jnp.clip(expand_srgb(srgb01), 0.0, 255.0).astype(jnp.uint8)
