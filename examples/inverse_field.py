"""Inverse rendering AT SCALE: recover a material's reflectance spectrum
on a 10,008-triangle field.

The gradient is ``jax.grad`` of the XLA wavefront (render/wavefront.py);
above DENSE_CUTOFF triangles the renderer attaches an LBVH
(models/scenes.py::auto_bvh), whose traversal only selects hits and
carries no tangents, so material gradients flow exactly as on the dense
scenes. This script perturbs the green material's sigmoid-spectrum
coefficients on the procedural field (walls + ~800 boxes) and descends the
pixel MSE back to the truth; every step is ONE jit.

Run (GPU by default):
  python examples/inverse_field.py
CPU smoke (tiny config):
  JAX_PLATFORMS=cpu SIZE=48 STEPS=12 N_TRIS=520 python examples/inverse_field.py

Reference anchor: the bounce loop being differentiated is
rendering/rendering.cu:12-40; the reference itself is forward-only.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

GREEN = 2  # material row (build_tri_field builder order)


def main() -> None:
    import optax

    from spectral_tpu.models.materials import tabulate
    from spectral_tpu.models.scenes import CORNELL, auto_bvh, build_tri_field, scene_camera
    from spectral_tpu.ops.rgb2spec import spd_from_coeffs_reflectance
    from spectral_tpu.render.wavefront import render_chunk

    n_tris = int(os.environ.get("N_TRIS", "10008"))
    size = int(os.environ.get("SIZE", "192"))
    steps = int(os.environ.get("STEPS", "80"))
    spp, bounces = 4, 5

    # build the LBVH once, outside the step
    scene = auto_bvh(build_tri_field(n_tris, seed=0, glass=True))
    w, h = size, size // 2
    cam = scene_camera(CORNELL, w, h)
    mats_true = scene.materials
    key = jax.random.PRNGKey(99)

    def render(c_row):
        mats = dataclasses.replace(
            mats_true, coeffs=mats_true.coeffs.at[GREEN].set(c_row)
        )
        s = dataclasses.replace(scene, materials=tabulate(mats))
        return render_chunk(s, cam, key, 0, 0, w, h, spp, bounces) / spp

    target = jax.jit(render)(mats_true.coeffs[GREEN])
    jax.block_until_ready(target)
    print("target rendered", flush=True)

    def spd_err(c_row):
        a = spd_from_coeffs_reflectance(c_row)
        b = spd_from_coeffs_reflectance(mats_true.coeffs[GREEN])
        return float(jnp.abs(a - b).max())

    # the SAME key as the target render (fixed-noise inverse MC, the
    # inverse_rendering.py pattern): the loss is deterministic and its
    # minimum is the true parameters. A fresh key per step against a
    # frozen noisy target is biased — the MSE's variance term depends on
    # the parameters, and the optimizer drifts toward darker albedos.
    step_fn = jax.jit(
        jax.value_and_grad(lambda c: jnp.mean((render(c) - target) ** 2))
    )

    # perturb the green spectrum (identifiable quantity = the SPD, not
    # the degenerate raw-coefficient basis — see inverse_rendering.py)
    c0 = mats_true.coeffs[GREEN] + jnp.asarray([0.0, 0.0, 1.5], jnp.float32)
    err0 = spd_err(c0)
    coeff_scale = jnp.asarray([1e-5, 5e-3, 1.0], jnp.float32)
    opt = optax.adam(0.05)
    opt_state = opt.init(c0)
    c = c0
    t0 = time.time()
    for i in range(steps):
        loss, g = step_fn(c)
        upd, opt_state = opt.update(g, opt_state)
        c = optax.apply_updates(c, upd * coeff_scale)
        if i % 10 == 9 or i == 0:
            print(
                f"step {i+1:3d}  loss {float(loss):.3e}  "
                f"spd err {spd_err(c):.4f}",
                flush=True,
            )
    dt = time.time() - t0
    err1 = spd_err(c)
    rec = 100.0 * (1.0 - err1 / err0)
    print(
        f"RESULT inverse_field {n_tris}tris {w}x{h}: spd err "
        f"{err0:.4f} -> {err1:.4f} ({rec:.0f}% recovered, "
        f"{dt/steps*1e3:.0f} ms/step avg incl. host)",
        flush=True,
    )
    if steps >= 40:
        # the 0.05/step Adam walk needs ~30 steps to cross the 1.5-unit
        # perturbation; short smoke configs only check descent
        assert rec >= 70.0, f"recovery {rec:.0f}% < 70%"
        print("recovered")
    else:
        assert err1 < err0, "loss not descending"
        print(f"descending (smoke config, {steps} steps)")


if __name__ == "__main__":
    main()
