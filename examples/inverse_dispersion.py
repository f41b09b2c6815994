"""Recover the prism glass's Sellmeier B coefficients from a target image.

BASELINE config 5's hard half: "recover material reflectance spectra +
prism Sellmeier coeffs". With the plain path-tracing estimator the pixel
loss is piecewise constant in B (measured AD = FD = 0.0),
so no amount of autodiff machinery helps; the hero-wavelength
reparameterization (spectral_tpu/diff/spectral_reparam.py) freezes the
refractive index along each sampled path and moves the B-dependence into
the smooth spectral factors, making per-sample AD an unbiased estimator
of the true d(image)/dB. This script is the end-to-end proof: perturb
B, descend the L2 pixel loss with reparameterized gradients, watch B
return to the truth.

Run (GPU by default; ~5 min on the CPU with JAX_PLATFORMS=cpu):
  python examples/inverse_dispersion.py
DISP_SIZE sets the image width (default 32).
"""

from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from spectral_tpu.models.scenes import PRISM, build_scene, scene_camera
from spectral_tpu.render.wavefront import render_chunk

GLASS = 2  # prism glass material row (scenes.build_prism)


def main() -> None:
    scene = build_scene(PRISM)
    # at 32 px the loss landscape's mean gradient is ZERO below B0
    # offsets of ~+0.04, capping recovery near 50%; at 64 px signal
    # remains down to ~+0.025
    size = int(os.environ.get("DISP_SIZE", "32"))
    spp, bounces = 16, 6
    cam = scene_camera(PRISM, size, size)
    b_true = scene.materials.sellmeier_b[GLASS]

    def set_b(b_glass):
        mats = scene.materials
        return dataclasses.replace(
            scene,
            materials=dataclasses.replace(
                mats, sellmeier_b=mats.sellmeier_b.at[GLASS].set(b_glass)
            ),
        )

    # Unbiased stochastic gradient of the expected-image MSE
    #   L(b) = mean_px (I(b) - I(b*))^2,  dL/db = mean_px 2 (I - I*) dI/db
    # with the two factors estimated from INDEPENDENT keys:
    #  - residual: common-random-numbers pair R(b,k1) - R(b*,k1), whose
    #    shared MC noise cancels (an independent-target residual has SNR
    #    ~0.1 on this scene and SGD diverges — measured in round 2);
    #  - gradient factor: the reparameterized vjp at key k2.
    # Sharing one key for both factors is NOT valid: the
    # reparameterization preserves expectations (linear functionals), not
    # per-key joint moments, and the correlated product E[AD * Delta]
    # acquires a first-order bias (round 2 watched it walk B0 uphill).
    # Loss over the UPPER-HALF crop: the dispersion signal concentrates
    # around the prism (measured delta-image rows 0-16); including the
    # signal-free lower rows only adds gradient variance.
    crop_w, crop_h = size, size // 2

    @jax.jit
    def one_grad(b_glass, k1, k2):
        ref = render_chunk(scene, cam, k1, 0, 0, crop_w, crop_h, spp, bounces)
        cur = render_chunk(
            set_b(b_glass), cam, k1, 0, 0, crop_w, crop_h, spp, bounces
        )
        resid = jax.lax.stop_gradient(cur - ref) / spp

        def f(bg):
            return render_chunk(
                set_b(bg), cam, k2, 0, 0, crop_w, crop_h, spp, bounces,
                reparam_glass=GLASS,
            ) / spp

        _, vjp = jax.vjp(f, b_glass)
        (g,) = vjp(2.0 * resid / resid.size)
        return jnp.mean(resid**2), g[0]

    # start displaced: +0.08 on B0 (a clearly wrong dispersion curve).
    # We optimize the SCALAR B0 with B1/B2 pinned: the three Sellmeier
    # numerators can nearly compensate one another inside the visible band
    # (a flat null direction — round 2 watched full-vector descent walk
    # along it), so per-coefficient recovery is the well-posed statement
    # of BASELINE config 5, matching the VERDICT's acceptance criterion.
    b = b_true + jnp.asarray([0.08, 0.0, 0.0])
    err0 = float(abs(b[0] - b_true[0]))
    print(f"start   |B0 - B0*| = {err0:.4f}  (B = {np.asarray(b)})")

    # Plain SGD with M-fold gradient averaging. The per-estimate SNR is
    # ~0.12 (heavy-tailed MC); M=8 averaging lifts a macro-step to ~0.35
    # and the first ~60 steps integrate the drift down to an
    # Ornstein-Uhlenbeck stationary band ~ sqrt(lr) ~ 0.02 — adaptive
    # optimizers (Adam) turn SNR<1 gradients into a pure random walk
    # here. Two standard refinements shrink the stationary error without
    # touching the estimator: (1) a 1/t learning-rate decay once the
    # drift phase is over (the OU band scales with sqrt(lr)), and
    # (2) Polyak-Ruppert averaging of the tail iterates (the OU noise is
    # mean-zero around the target, so the iterate average concentrates
    # faster than any single iterate).
    # Fixed-point calibration (K=512 at 32px/spp16 and K=96 at
    # 64px/spp32): the mean estimator
    # gradient is ZERO within +-1e-4 at B0 offsets +0.005..+0.025 — a
    # FLAT-LOSS region, not estimator bias (the round-3 "band-edge
    # window bias" zero-crossing was probe noise: the tail clip is
    # inert — clip/wide-clip traces identical, clipfrac 0 — and a
    # narrower edge window only adds variance). At far offsets the
    # drift signal is ~+2e-4..4e-4 per estimate (matches the observed
    # lr*g*steps ~ 0.09 drift integral), falling under the ~1e-4 noise
    # floor below |dB0| ~ 0.03: the ~75-85% recovery floor is a
    # property of this scene/config's loss landscape SNR, and pushing
    # past it needs estimator variance reduction (more spp/res in the
    # gradient factor), not a different gradient estimator.
    # The drift time constant at lr 2.2 is ~77 steps, so the schedule
    # holds lr constant for ~2.5 tau before the 1/t decay phase.
    lr0, M, drift_steps, total_steps = 2.2, 8, 200, 260
    key = jax.random.PRNGKey(7)
    tail = []
    for step in range(1, total_steps + 1):
        gacc, L = 0.0, 0.0
        for _ in range(M):
            key, k1, k2 = jax.random.split(key, 3)
            Li, gi = one_grad(b, k1, k2)
            gacc += float(jnp.clip(gi, -0.05, 0.05))  # tail clip
            L = float(Li)
        lr = lr0 / (1.0 + max(0, step - drift_steps) / 10.0)
        b = b.at[0].add(-lr * gacc / M)
        if step > drift_steps:
            tail.append(float(b[0]))
        if step % 20 == 0:
            err = float(abs(b[0] - b_true[0]))
            print(
                f"step {step:3d}  loss {L:.3e}  lr {lr:.2f}  "
                f"|B0 - B0*| = {err:.4f}"
            )

    b0_hat = float(np.mean(tail))  # Polyak average of the decay phase
    err = float(abs(b0_hat - b_true[0]))
    print(f"final   |B0 - B0*| = {err:.4f}  (tail-averaged B0 = {b0_hat:.4f})")
    print(f"recovered {100.0 * (1.0 - err / err0):.1f}% of the perturbation")
    # the estimator's measured fixed point (see calibration note above)
    # bounds recovery at ~75-85%, flat across a 4x pixel / 3x gradient-
    # sample increase: the floor is the loss landscape. Assert
    # comfortably inside the measured 75% plateau.
    assert err < 0.35 * err0, "dispersion recovery failed"


if __name__ == "__main__":
    main()
