"""Material table: SoA parameters + differentiable SPD tabulation.

The reference's ``material`` is a POD struct with a type tag, rgb color,
fuzz, emission power, a precomputed 95-sample spectral distribution, and
Sellmeier B/C coefficients (reference: materials/material.cuh:140-149;
factories at material.cuh:100-117; SPD precompute compute_spectral_distr at
material.cuh:71-84). Here it is a struct-of-arrays pytree in
which the *learnable* quantities (sigmoid-poly coefficients, emission power,
fuzz, Sellmeier B/C) are leaves, so ``jax.grad`` flows through the renderer
into them, and the SPD table is a pure function of those leaves.

Material type ids match the reference (material.cuh:16-22).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.rgb2spec import (
    fit_sigmoid_coeffs,
    spd_from_coeffs_illuminance,
    spd_from_coeffs_reflectance,
)
from ..utils.constants import N_CIE_SAMPLES, sellmeier_presets

LAMBERTIAN = 0
METALLIC = 1
DIELECTRIC = 2
EMISSIVE = 4
NO_MAT = 6


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Materials:
    """SoA material table over M materials.

    ``mat_type`` is static-per-scene discrete data; everything else is a
    differentiable leaf. ``spd`` is the tabulated 95-sample spectrum the
    renderer samples; rebuild it with ``tabulate`` after changing leaves.
    """

    mat_type: jnp.ndarray  # [M] int32
    rgb: jnp.ndarray  # [M, 3] linear-sRGB color (diagnostic / refit input)
    coeffs: jnp.ndarray  # [M, 3] sigmoid-poly coefficients
    fuzz: jnp.ndarray  # [M]
    emission_power: jnp.ndarray  # [M]
    sellmeier_b: jnp.ndarray  # [M, 3]
    sellmeier_c: jnp.ndarray  # [M, 3]
    spd: jnp.ndarray  # [M, N_CIE_SAMPLES]


class MaterialBuilder:
    """Host-side accumulation of materials, mirroring the reference factories."""

    def __init__(self, replicate_reference_bugs: bool = True):
        # The reference's dielectric ctor stores C := B (material.cuh:63-69),
        # so its rendered dispersion uses C == B. We replicate by default for
        # image parity and expose the physically-correct path as an option.
        self._rows: list[dict] = []
        self._replicate = replicate_reference_bugs

    def _add(self, mat_type, rgb=(0.0, 0.0, 0.0), fuzz=1.0, power=0.0, b=(0.0,) * 3, c=(0.0,) * 3) -> int:
        self._rows.append(
            dict(
                mat_type=mat_type,
                rgb=np.asarray(rgb, np.float32),
                fuzz=np.float32(fuzz),
                power=np.float32(power),
                b=np.asarray(b, np.float32),
                c=np.asarray(c, np.float32),
            )
        )
        return len(self._rows) - 1

    def lambertian(self, rgb) -> int:
        return self._add(LAMBERTIAN, rgb)

    def metallic(self, rgb, fuzz: float) -> int:
        return self._add(METALLIC, rgb, fuzz=fuzz)

    def emissive(self, rgb, power: float = 1.0) -> int:
        return self._add(EMISSIVE, rgb, power=power)

    def dielectric(self, b, c) -> int:
        c_eff = b if self._replicate else c
        return self._add(DIELECTRIC, (1.0, 1.0, 1.0), b=b, c=c_eff)

    def dielectric_preset(self, name: str) -> int:
        b, c = sellmeier_presets[name]
        return self.dielectric(np.asarray(b), np.asarray(c))

    def build(self) -> Materials:
        m = len(self._rows)
        g = lambda k: np.stack([r[k] for r in self._rows])  # noqa: E731
        mats = Materials(
            mat_type=jnp.asarray(np.array([r["mat_type"] for r in self._rows], np.int32)),
            rgb=jnp.asarray(g("rgb")),
            coeffs=fit_sigmoid_coeffs(jnp.asarray(g("rgb"))),
            fuzz=jnp.asarray(g("fuzz")),
            emission_power=jnp.asarray(g("power")),
            sellmeier_b=jnp.asarray(g("b")),
            sellmeier_c=jnp.asarray(g("c")),
            spd=jnp.zeros((m, N_CIE_SAMPLES), jnp.float32),
        )
        return tabulate(mats)


def tabulate(mats: Materials) -> Materials:
    """(Re)build the 95-sample SPD table from the differentiable leaves.

    Mirrors material::compute_spectral_distr (reference material.cuh:71-84):
    EMISSIVE -> power^2-scaled D65-weighted sigmoid spectrum; DIELECTRIC ->
    constant 1; everything else -> reflectance sigmoid spectrum.
    """
    refl = spd_from_coeffs_reflectance(mats.coeffs)
    emis = spd_from_coeffs_illuminance(mats.coeffs, mats.emission_power)
    ones = jnp.ones_like(refl)
    t = mats.mat_type[:, None]
    spd = jnp.where(t == EMISSIVE, emis, jnp.where(t == DIELECTRIC, ones, refl))
    return dataclasses.replace(mats, spd=spd)
