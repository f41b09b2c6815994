"""The wavefront spectral path tracer.

The plain-JAX form of the reference's megakernel (spectral_render_kernel,
rendering/rendering.cu:151-235): instead of one thread owning a pixel
through all samples and bounces, a *batch* of rays advances in lockstep
through ``lax.scan`` stages

    generate -> [ intersect -> shade ] x bounce_limit -> integrate

with the sample loop as an outer scan accumulating XYZ. Every stage is a
dense batched op, so there is no divergence -- dead rays are masked, not
branched. This is the differentiable reference: every gradient is
``jax.grad`` of it, and the Pallas megakernel is held to it.

The per-(pixel,sample,bounce) RNG is a folded counter key, replacing the
persistent curand states (rendering.cu:120-138).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..models.camera import Camera, generate_rays
from ..models.scenes import auto_bvh
from ..ops.color import to_uint8, xyz_to_srgb
from ..ops.intersect import nearest_hit
from ..ops.shading import RayState, scatter_step
from ..ops.spectrum import hero_wavelengths, spectrum_to_xyz
from ..utils.constants import N_RAY_WAVELENGTHS
from ..utils.prng import fold


def _warn_specular_fraction(frac) -> None:
    """Host callback for the vertex-gradient specular-chain guard: warn
    when more than SPECULAR_WARN_FRAC (default 0.25) of contributing
    paths crossed a metal/dielectric bounce — the warped-area estimator
    misses silhouettes seen only through specular chains, so gradients
    on such scenes carry a systematic deficit (diff/vertex_warp.py)."""
    import os
    import warnings

    thresh = float(os.environ.get("SPECULAR_WARN_FRAC", "0.25"))
    f = float(frac)
    if f > thresh:
        warnings.warn(
            f"vertex-gradient estimator: {f:.0%} of contributing paths "
            f"crossed a metal/dielectric bounce (> {thresh:.0%} "
            f"threshold). Silhouettes visible only through specular "
            f"chains carry NO boundary term in the warped-area "
            f"estimator — vertex gradients on this scene may be "
            f"systematically low (diff/vertex_warp.py, known gaps).",
            stacklevel=2,
        )


def trace_paths(
    scene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    wavelengths: jnp.ndarray,
    key: jax.Array,
    bounce_limit: int,
    vertex_warp=None,
    fuzz_warp=None,
) -> RayState:
    """Trace a ray batch to termination (renderer::ray_bounce,
    reference rendering.cu:12-40, vectorized over rays).

    ``vertex_warp``: optional EdgeSet (diff/vertex_warp.py) activating the
    warped-area vertex-gradient estimator on lambertian bounces."""
    n = o.shape[0]
    state = RayState(
        o=o,
        d=d,
        wavelengths=wavelengths,
        power=jnp.ones((n, wavelengths.shape[1]), jnp.float32),
        n_valid=jnp.full((n,), wavelengths.shape[1], jnp.int32),
        alive=jnp.ones((n,), bool),
    )

    use_bvh = getattr(scene, "bvh", None) is not None

    def bounce(carry, b: jnp.ndarray):
        state, spec = carry
        if use_bvh:
            from ..ops.bvh import nearest_hit_bvh

            rec = nearest_hit_bvh(state.o, state.d, scene, scene.bvh)
        else:
            rec = nearest_hit(state.o, state.d, scene)
        if vertex_warp is not None:
            # specular-chain monitor (documented estimator blind spot):
            # silhouettes seen only through metal/dielectric bounces get
            # no boundary term, so flag paths that cross one
            from ..models.materials import DIELECTRIC, METALLIC

            mt = scene.materials.mat_type[rec.mat_index]
            spec = spec | (
                state.alive & rec.hit & ((mt == METALLIC) | (mt == DIELECTRIC))
            )
        state = scatter_step(
            state, rec, scene.materials, scene.background_spd, fold(key, b),
            vertex_warp=vertex_warp, fuzz_warp=fuzz_warp,
        )
        return (state, spec), None

    # remat the bounce so the backward pass re-runs intersection instead of
    # saving [N, T] candidate tensors per bounce
    (state, spec), _ = jax.lax.scan(
        jax.checkpoint(bounce),
        (state, jnp.zeros((n,), bool)),
        jnp.arange(bounce_limit),
    )

    # paths still alive after the bounce limit contribute nothing
    # (rendering.cu:38-39)
    state = state._replace(n_valid=jnp.where(state.alive, 0, state.n_valid))
    if vertex_warp is not None:
        # Runtime guard (round-4): warn when the vertex-gradient
        # estimator is active and a large fraction of the CONTRIBUTING
        # paths crossed a specular bounce — on such scenes the missing
        # specular-chain boundary terms are no longer a small residual
        # (diff/vertex_warp.py "known gaps"). Host-side threshold via
        # SPECULAR_WARN_FRAC (default 0.25); the callback is negligible
        # (one scalar per trace) and only runs under vertex_warp.
        contrib = state.n_valid > 0
        frac = jnp.sum((spec & contrib).astype(jnp.float32)) / jnp.maximum(
            jnp.sum(contrib.astype(jnp.float32)), 1.0
        )
        # SPECULAR_WARN=0 disables the host callback outright
        import os as _os

        if _os.environ.get("SPECULAR_WARN", "1") == "1":
            jax.debug.callback(_warn_specular_fraction, frac)
    return state


def render_tile_xyz(
    scene,
    cam: Camera,
    px: jnp.ndarray,
    py: jnp.ndarray,
    key: jax.Array,
    samples_per_pixel: int,
    bounce_limit: int,
    reparam_glass: int | None = None,
    reparam_frozen: tuple[jnp.ndarray, jnp.ndarray] | None = None,
    vertex_warp=None,
    fuzz_warp=None,
) -> jnp.ndarray:
    """Accumulated (not averaged) XYZ for a flat batch of pixels [N] ->
    [N, 3]. Mirrors the sample loop of spectral_render_kernel
    (rendering.cu:215-228).

    ``reparam_glass``: material index of a dispersive dielectric to take
    EXACT Sellmeier B/C gradients against (diff/spectral_reparam.py —
    hero-wavelength change of variables; primal values unchanged).
    ``reparam_frozen``: explicit (b0, c0) target pair, used by FD checks
    (see reparam_hero's docstring); default tracks-but-detaches.
    ``vertex_warp``: optional EdgeSet enabling exact vertex-position
    gradients (diff/vertex_warp.py): warps camera pixel samples and
    lambertian bounce directions so silhouette boundary terms appear in
    ordinary autodiff; primal rays are geometrically unchanged (the
    sphere warp normalizes the lambertian direction, so pixel values
    deviate only at f32-rounding level, ~1e-6 relative).
    """
    n = px.shape[0]
    # above DENSE_CUTOFF triangles the scene gets an LBVH, built once here
    # (outside the sample scan) when the caller did not attach one
    scene = auto_bvh(scene)

    screen_warp = None
    if vertex_warp is not None:
        from ..diff.vertex_warp import warp_pixel_samples

        screen_warp = lambda fx, fy: warp_pixel_samples(cam, vertex_warp, fx, fy)

    def sample(acc: jnp.ndarray, s: jnp.ndarray) -> tuple[jnp.ndarray, None]:
        k = fold(key, s)
        k_ray, k_lam, k_path = jax.random.split(k, 3)
        if screen_warp is not None:
            o, d, cam_det = generate_rays(cam, px, py, k_ray, screen_warp=screen_warp)
        else:
            o, d = generate_rays(cam, px, py, k_ray)
            cam_det = None
        lam = hero_wavelengths(k_lam, (n,), N_RAY_WAVELENGTHS)
        jac = None
        if reparam_glass is not None:
            from ..diff.spectral_reparam import reparam_wavelengths

            lam, jac = reparam_wavelengths(
                lam, scene.materials, reparam_glass, reparam_frozen
            )
        state = trace_paths(
            scene, o, d, lam, k_path, bounce_limit, vertex_warp, fuzz_warp
        )
        xyz = spectrum_to_xyz(state.wavelengths, state.power, state.n_valid)
        if jac is not None:
            xyz = xyz * jac[:, None]
        if cam_det is not None:
            xyz = xyz * cam_det[:, None]
        return acc + xyz, None

    acc, _ = jax.lax.scan(sample, jnp.zeros((n, 3), jnp.float32), jnp.arange(samples_per_pixel))
    return acc


@partial(
    jax.jit,
    static_argnames=(
        "samples_per_pixel", "bounce_limit", "width", "height", "x0", "y0",
        "reparam_glass",
    ),
)
def render_chunk(
    scene,
    cam: Camera,
    key: jax.Array,
    x0: int,
    y0: int,
    width: int,
    height: int,
    samples_per_pixel: int,
    bounce_limit: int,
    reparam_glass: int | None = None,
    reparam_frozen: tuple[jnp.ndarray, jnp.ndarray] | None = None,
    vertex_warp=None,
    fuzz_warp=None,
) -> jnp.ndarray:
    """Render a rectangular chunk -> accumulated XYZ [height, width, 3].

    The chunk is the reference's tile (render_manager.cu:3-66): the unit of
    progressive display, host streaming, and device-mesh sharding.
    ``reparam_glass`` enables exact Sellmeier gradients (render_tile_xyz);
    ``reparam_frozen`` pins the target index for FD checks; ``vertex_warp``
    (EdgeSet) enables exact vertex-position gradients.
    """
    ys, xs = jnp.meshgrid(
        jnp.arange(y0, y0 + height, dtype=jnp.int32),
        jnp.arange(x0, x0 + width, dtype=jnp.int32),
        indexing="ij",
    )
    xyz = render_tile_xyz(
        scene, cam, xs.ravel(), ys.ravel(), key, samples_per_pixel,
        bounce_limit, reparam_glass, reparam_frozen, vertex_warp, fuzz_warp,
    )
    return xyz.reshape(height, width, 3)


def xyz_to_image(xyz_sum: jnp.ndarray, samples_per_pixel: int) -> jnp.ndarray:
    """XYZ accumulator -> uint8 sRGB image (save_to_fb, rendering.cu:140-149
    + frame_buffer uchar conversion)."""
    return to_uint8(xyz_to_srgb(xyz_sum / float(samples_per_pixel)))
