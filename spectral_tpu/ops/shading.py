"""Branchless spectral material shading (the wavefront bounce step).

The reference prototyped exactly this formulation in
material::unified_scatter (materials/material.cu:138-183): compute the
lambertian / metallic / dielectric scatter directions for EVERY ray, then
blend with one-hot material weights. That is the natural SIMD program,
so it is the ONLY formulation here -- the branchy scatter()
(material.cu:56-100) exists in the reference purely for warp-divergence
experiments and computes the same distribution.

Semantics replicated exactly (citations into /root/reference):
- lambertian: normal + uniform-unit-vector, degenerate -> normal
  (material.cu:8-19, near_zero threshold vec3.cuh:94-98)
- metallic: mirror + fuzz * unit vector; absorbed (all wavelengths zeroed)
  if the fuzzed direction dips below the surface (material.cu:22-37, 64-68)
- dielectric: Sellmeier n(hero lambda), Schlick-probabilistic
  reflect/refract; ON REFRACTION the ray collapses to 1 valid wavelength --
  the mechanism behind the prism rainbow (material.cu:73-80, 102-136)
- emissive: multiply emission SPD then terminate (material.cu:83-86)
- all paths multiply the ray spectrum by the material SPD and offset the
  origin +-EPSILON along the normal (material.cu:95-97)
- miss: multiply by background SPD and terminate (rendering.cu:24-27)
- bounce-limit exhaustion: zero valid wavelengths (rendering.cu:38-39)

Wavelength bookkeeping: the reference's ``valid_wavelengths`` prefix counter
means "spectrum entries beyond the counter are dead". Multiplying dead lanes
is observationally identical (they are never read by the final XYZ
integration), so we multiply all lanes unconditionally and only track the
counter -- fully branchless.

Gradient policy: discrete decisions (one-hot material weights, Schlick
branch, absorb test, degenerate-direction test, RNG draws) are detached;
directions, Sellmeier index, SPD weights and hit geometry carry gradients.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.constants import EPSILON
from ..utils.prng import random_unit_vectors
from .intersect import HitRecord
from .sellmeier import sellmeier_index
from .spectrum import spectrum_interp_shared


class RayState(NamedTuple):
    """Wavefront SoA ray state (reference ray/ray.cuh:15-78)."""

    o: jnp.ndarray  # [N, 3] origin
    d: jnp.ndarray  # [N, 3] direction (not normalized)
    wavelengths: jnp.ndarray  # [N, W], hero at index 0
    power: jnp.ndarray  # [N, W]
    n_valid: jnp.ndarray  # [N] int32 prefix counter of live wavelengths
    alive: jnp.ndarray  # [N] bool: still bouncing


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _normalize(v):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def _reflect(v, n):
    """reference math/vec3.cuh:179-183."""
    return v - 2.0 * _dot(v, n)[..., None] * n


def _refract(uv, n, ratio):
    """Snell refraction (reference math/vec3.cuh:198-205)."""
    cos_theta = jnp.minimum(_dot(-uv, n), 1.0)
    r_perp = ratio[..., None] * (uv + cos_theta[..., None] * n)
    # floor at 1e-24, NOT 0: sqrt's vjp coefficient at an exactly-zero
    # argument is inf, and maximum's vjp propagates it on the x==floor
    # tie. Under lax.scan zero cotangents are materialized (not symbolic),
    # so 0 * inf = NaN poisons the whole carried gradient. sqrt(1e-24) is
    # below the f32 ulp of these O(1) directions: primal bit-identical.
    par_mag = jnp.sqrt(jnp.maximum(1.0 - _dot(r_perp, r_perp), 1e-24))
    return r_perp - par_mag[..., None] * n


def _schlick(cosine, ref_idx):
    """Schlick reflectance (reference material.cu:39-53)."""
    r0 = ((1.0 - ref_idx) / (1.0 + ref_idx)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def _interp_rows(spd_rows: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """Per-ray SPD rows [N, S] sampled at per-ray wavelengths [N, W].

    Same clamped lerp as ray::mul_spectrum -> spectrum_interp
    (ray.cuh:60-69, spectrum.cu:11-22), via the select-chain formulation
    (ops/spectrum.py::_select_lerp)."""
    from ..utils.constants import LAMBDA_MAX, LAMBDA_MIN
    from .spectrum import _select_lerp

    s = spd_rows.shape[-1]
    x = (lam - LAMBDA_MIN) * ((s - 1) / (LAMBDA_MAX - LAMBDA_MIN))
    cell = jnp.clip(x.astype(jnp.int32), 0, s - 2)
    w = x - cell.astype(x.dtype)
    return _select_lerp(
        lambda k: spd_rows[..., k : k + 1],
        lambda k: spd_rows[..., k + 1 : k + 2],
        cell,
        w,
        s,
    )


def scatter_step(
    state: RayState,
    rec: HitRecord,
    materials,
    background_spd: jnp.ndarray,
    key: jax.Array,
    vertex_warp=None,
    fuzz_warp=None,
) -> RayState:
    """One wavefront bounce: classify, scatter, attenuate, terminate.

    Equivalent to one iteration of renderer::ray_bounce
    (reference rendering/rendering.cu:12-40) over the whole ray batch.

    ``vertex_warp``: an EdgeSet (diff/vertex_warp.py) enabling the
    warped-area vertex-gradient estimator on the lambertian bounce: the
    cosine map uses the DETACHED normal, the sampled direction is warped
    to track silhouette motion, and the det x density-ratio factor
    (value 1 at the primal) multiplies the ray spectrum.
    ``fuzz_warp``: an EdgeSet enabling exact d/d(fuzz) on the metallic
    lobe (diff/fuzz_warp.py; geometry detached — fuzz-only).
    """
    from ..models.materials import DIELECTRIC, EMISSIVE, LAMBERTIAN, METALLIC

    n = state.o.shape[0]
    k_lamb, k_fuzz, k_schlick = jax.random.split(key, 3)

    active = state.alive  # rays participating in this bounce
    hit = rec.hit & active
    miss = (~rec.hit) & active

    # --- gather material rows (detached discrete index) ---
    mi = jax.lax.stop_gradient(rec.mat_index)
    mtype = materials.mat_type[mi]  # [N]
    spd = materials.spd[mi]  # [N, S]
    fuzz = materials.fuzz[mi]  # [N]
    sell_b = materials.sellmeier_b[mi]  # [N, 3]
    sell_c = materials.sellmeier_c[mi]

    unit_in = _normalize(state.d)
    normal = rec.normal

    # --- lambertian lobe (material.cu:8-19) ---
    u1 = random_unit_vectors(k_lamb, (n,))
    warp_factor = None
    if vertex_warp is None:
        lamb_dir = normal + u1
        degen = jnp.all(jnp.abs(lamb_dir) < 1e-8, axis=-1)
        lamb_dir = jnp.where(degen[:, None], normal, lamb_dir)
    else:
        from ..diff.vertex_warp import warp_directions

        n_frozen = jax.lax.stop_gradient(normal)
        d0 = n_frozen + u1
        degen = jnp.all(jnp.abs(d0) < 1e-8, axis=-1)
        d0 = jnp.where(degen[:, None], n_frozen, d0)
        w0 = _normalize(d0)  # theta-fixed integration variable
        # Evaluate the warp ONLY at well-conditioned origins: dead, missed
        # and non-lambertian lanes park at a far-away point where every
        # edge distance is large. A dead lane's hit point defaults to the
        # world origin — a Cornell box CORNER, on three edges at once —
        # and its (value-masked) warp derivatives overflow and poison the
        # shared backward sums with 0*inf (scratch/ray_bisect.py).
        lamb_sel = (
            (materials.mat_type[mi] != METALLIC)
            & (materials.mat_type[mi] != DIELECTRIC)
            & (materials.mat_type[mi] != EMISSIVE)
        )
        use_warp = hit & lamb_sel
        far = jnp.array([1.0e4, 2.0e4, 3.0e4], jnp.float32)
        o_safe = jnp.where(use_warp[:, None], rec.p, far)
        n_safe = jnp.where(
            use_warp[:, None], normal, jnp.array([0.0, 0.0, 1.0], jnp.float32)
        )
        lamb_dir, warp_factor = warp_directions(o_safe, n_safe, w0, vertex_warp)
        lamb_dir = jnp.where(use_warp[:, None], lamb_dir, d0)
        warp_factor = jnp.where(use_warp, warp_factor, 1.0)

    # --- metallic lobe (material.cu:22-37) ---
    u2 = random_unit_vectors(k_fuzz, (n,))
    refl = _reflect(unit_in, normal)
    fuzz_factor = None
    if fuzz_warp is None:
        metal_dir = refl + fuzz[:, None] * u2
    else:
        from ..diff.fuzz_warp import FUZZ_MIN, warp_fuzz

        # same far-parking as the lambertian warp: only live metallic
        # hits with trainable-scale fuzz evaluate the warp
        metal_sel = materials.mat_type[mi] == METALLIC
        use_fw = hit & metal_sel & jax.lax.stop_gradient(fuzz > FUZZ_MIN)
        far = jnp.array([1.0e4, 2.0e4, 3.0e4], jnp.float32)
        zhat = jnp.array([0.0, 0.0, 1.0], jnp.float32)
        o_safe = jnp.where(use_fw[:, None], rec.p, far)
        r_safe = jnp.where(
            use_fw[:, None], jax.lax.stop_gradient(refl), zhat
        )
        n_safe = jnp.where(
            use_fw[:, None], jax.lax.stop_gradient(normal), zhat
        )
        s_w, fdet = warp_fuzz(u2, o_safe, r_safe, n_safe, fuzz, fuzz_warp)
        metal_dir = refl + fuzz[:, None] * jnp.where(
            use_fw[:, None], s_w, u2
        )
        fuzz_factor = jnp.where(use_fw, fdet, 1.0)
    metal_ok = _dot(metal_dir, normal) > 0.0

    # --- dielectric lobe (material.cu:73-80, 102-136) ---
    hero = state.wavelengths[:, 0]
    ir = sellmeier_index(sell_b, sell_c, hero)
    ratio = jnp.where(rec.front_face, 1.0 / ir, ir)
    cos_theta = jnp.minimum(_dot(-unit_in, normal), 1.0)
    # 1e-24 floor: see _refract — sqrt-at-exactly-0 has an inf vjp
    # coefficient that NaNs materialized-zero cotangents under lax.scan
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 1e-24))
    u_refl = jax.random.uniform(k_schlick, (n,), jnp.float32)
    cannot_refract = (ratio * sin_theta > 1.0) | (
        _schlick(cos_theta, ratio) > u_refl
    )
    cannot_refract = jax.lax.stop_gradient(cannot_refract)
    diel_dir = jnp.where(
        cannot_refract[:, None],
        _reflect(unit_in, normal),
        _refract(unit_in, normal, ratio),
    )
    refracted = ~cannot_refract

    # --- one-hot blend (unified_scatter, material.cu:138-183) ---
    # LAMBERTIAN is the reference's switch default (material.cu:88-92), so
    # any unknown type scatters lambertian
    is_lamb = (mtype != METALLIC) & (mtype != DIELECTRIC) & (mtype != EMISSIVE)
    is_metal = mtype == METALLIC
    is_diel = mtype == DIELECTRIC
    is_emis = mtype == EMISSIVE

    new_dir = (
        is_lamb[:, None] * lamb_dir
        + is_metal[:, None] * metal_dir
        + is_diel[:, None] * diel_dir
    )

    # epsilon correction: refracting dielectrics push through the surface
    # (material.cu:95-97, 127-131)
    eps_sign = jnp.where(is_diel & refracted, -1.0, 1.0)
    new_o = rec.p + eps_sign[:, None] * EPSILON * normal

    # --- spectrum updates ---
    mat_weight = _interp_rows(spd, state.wavelengths)  # [N, W]
    bg_weight = spectrum_interp_shared(background_spd, state.wavelengths)
    weight = jnp.where(
        hit[:, None], mat_weight, jnp.where(miss[:, None], bg_weight, 1.0)
    )
    power = state.power * weight
    if warp_factor is not None:
        # det x density-ratio of the warped-area estimator: value 1 at the
        # primal, carries the lambertian-bounce boundary + normal-tilt terms
        power = power * jnp.where(hit & is_lamb, warp_factor, 1.0)[:, None]
    if fuzz_factor is not None:
        # tangent-plane det of the fuzz-sphere warp: value 1 at the
        # primal, carries the metal-lobe fuzz boundary terms
        power = power * jnp.where(hit & is_metal, fuzz_factor, 1.0)[:, None]

    # wavelength collapse on refraction (material.cu:78-79); metal absorb
    # zeroes the spectrum (material.cu:66-68)
    n_valid = state.n_valid
    n_valid = jnp.where(hit & is_diel & refracted, 1, n_valid)
    n_valid = jnp.where(hit & is_metal & ~metal_ok, 0, n_valid)

    # --- termination ---
    terminated = miss | (hit & is_emis) | (hit & is_metal & ~metal_ok)
    alive = active & ~terminated

    # rays that were already finished keep their state frozen
    frozen = ~active
    new_o = jnp.where(frozen[:, None], state.o, new_o)
    new_d = jnp.where(frozen[:, None] | terminated[:, None], state.d, new_dir)
    power = jnp.where(frozen[:, None], state.power, power)
    n_valid = jnp.where(frozen, state.n_valid, n_valid)

    return RayState(
        o=new_o,
        d=new_d,
        wavelengths=state.wavelengths,
        power=power,
        n_valid=n_valid,
        alive=alive,
    )
