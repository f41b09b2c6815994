"""Inverse rendering demo (BASELINE config 5, spectra half): recover
material reflectance spectra from a target image by pixel gradients.

The reference renderer is forward-only; this is the flagship NEW capability.
We render a target Cornell image, perturb the white-wall sigmoid
coefficients, then descend the L2 pixel loss back to the truth with the
mesh-sharded differentiable renderer. The OTHER half of config 5 —
recovering the prism glass's Sellmeier coefficients — needs the
hero-wavelength reparameterization (plain per-sample gradients of
dispersion are zero a.e.) and lives in examples/inverse_dispersion.py.

Run (CPU, virtual 8-device mesh):
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python examples/inverse_rendering.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from spectral_tpu.models.scenes import CORNELL, build_scene, scene_camera
from spectral_tpu.parallel import (
    apply_params,
    make_mesh,
    render_image_sharded,
    train_step,
    trainable_params,
)


def main() -> None:
    scene = build_scene(CORNELL)
    size = 32
    cam = scene_camera(CORNELL, size, size)
    mesh = make_mesh(len(jax.devices()))
    spp, bounces = 8, 4
    key = jax.random.PRNGKey(0)

    target = render_image_sharded(scene, cam, key, mesh, spp, bounces) / spp

    truth = trainable_params(scene)
    params = dict(truth)
    # perturb: white-wall color coeffs (material 3, the dominant surface)
    params["coeffs"] = params["coeffs"].at[3, 2].add(1.5)

    from spectral_tpu.ops.rgb2spec import spd_from_coeffs_reflectance

    def spd_err(p):
        """Max SPD deviation of the perturbed material — the identifiable
        quantity (the raw coefficient basis is degenerate: many triples
        produce near-identical spectra)."""
        a = spd_from_coeffs_reflectance(p["coeffs"][3])
        b = spd_from_coeffs_reflectance(truth["coeffs"][3])
        return float(jnp.abs(a - b).max())

    import optax

    # precondition the raw-lambda basis: c0 multiplies lambda^2 (~4e5), so
    # its natural scale is ~1e-6 of c2's. Scale per-coordinate steps.
    coeff_scale = jnp.asarray([1e-5, 5e-3, 1.0], jnp.float32)
    opt = optax.adam(0.05)
    opt_state = opt.init(params)

    @jax.jit
    def loss_fn(p):
        s = apply_params(scene, p)
        # SAME key as the target render: the loss is deterministic and its
        # minimum is the true parameters (standard fixed-noise inverse MC)
        img = render_image_sharded(s, cam, key, mesh, spp, bounces) / spp
        return jnp.mean((img - target) ** 2)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    print(f"initial: spd err {spd_err(params):.4f}  loss {float(loss_fn(params)):.3e}")
    for step in range(120):
        loss, grads = grad_fn(params)
        updates, opt_state = opt.update(grads, opt_state)
        updates = dict(updates)
        updates["coeffs"] = updates["coeffs"] * coeff_scale
        params = optax.apply_updates(params, updates)
        if step % 30 == 29:
            print(f"step {step+1:3d}  loss {float(loss):.3e}  spd err {spd_err(params):.4f}")

    ce = spd_err(params)
    print("recovered" if ce < 0.03 else "partial recovery", f"(spd err {ce:.4f})")


if __name__ == "__main__":
    main()
