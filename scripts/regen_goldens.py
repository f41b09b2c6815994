"""Regenerate tests/goldens/*.npy after a DELIBERATE semantic change.

The XLA goldens come from ``render_chunk``; the megakernel goldens from
``render_chunk_pallas`` through the Pallas interpreter under the injected
uniforms that tests/test_goldens.py reconstructs. (The committed
megakernel goldens were first written by the previous megakernel; the
current one reproduces them to f32 rounding.)

Run: JAX_PLATFORMS=cpu python scripts/regen_goldens.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

import jax
import jax.numpy as jnp
import numpy as np

from spectral_tpu.models.scenes import CORNELL, PRISM, build_scene, scene_camera
from spectral_tpu.ops.pallas.render_kernel import n_uniforms, render_chunk_pallas
from spectral_tpu.render.wavefront import render_chunk
from test_goldens import MEGAKERNEL_GOLDENS, render_megakernel_golden

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "goldens")


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    cornell = build_scene(CORNELL)
    cam = scene_camera(CORNELL, 24, 24)
    np.save(
        os.path.join(OUT, "cornell_xla_24px.npy"),
        np.asarray(render_chunk(cornell, cam, jax.random.PRNGKey(123), 0, 0, 24, 24, 4, 3)),
    )
    rand = jax.random.uniform(
        jax.random.PRNGKey(42), (4, n_uniforms(3), 1024), jnp.float32
    )[:, :, :576]
    np.save(
        os.path.join(OUT, "cornell_pallas_24px.npy"),
        np.asarray(
            render_chunk_pallas(cornell, cam, 9, 0, 0, 24, 24, 4, 3, interpret=True, rand=rand)
        ),
    )
    prism = build_scene(PRISM)
    np.save(
        os.path.join(OUT, "prism_xla_24px.npy"),
        np.asarray(
            render_chunk(prism, scene_camera(PRISM, 24, 24), jax.random.PRNGKey(7), 0, 0, 24, 24, 4, 5)
        ),
    )
    for name in MEGAKERNEL_GOLDENS:
        np.save(os.path.join(OUT, name), render_megakernel_golden(name))
    print("goldens written to", os.path.normpath(OUT))


if __name__ == "__main__":
    main()
