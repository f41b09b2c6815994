"""Golden-image regression tests.

Both render paths are deterministic given their random numbers (the XLA
path via a jax.random key; the megakernel via injected uniform arrays), so
small renders are pinned against committed goldens. Any semantic change to
the light transport — intersection, shading, spectral pipeline, color —
shows up here immediately.

The ``*_megakernel*`` goldens and ``cornell_pallas_24px`` were written by
the previous megakernel under the same injected uniforms; the
current kernel reproduces them through the Pallas interpreter to f32
rounding (measured max relative error 5e-6). Regenerate deliberately with
scripts/regen_goldens.py after a semantic change.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectral_tpu.models.camera import make_camera
from spectral_tpu.models.scenes import CORNELL, PRISM, TRIS, build_scene, scene_camera
from spectral_tpu.ops.pallas.render_kernel import n_uniforms, render_chunk_pallas
from spectral_tpu.render.wavefront import render_chunk

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _golden(name):
    return np.load(os.path.join(GOLDEN_DIR, name))


def _thin_lens(w, h):
    return make_camera(
        w, h, vfov=40.0, lookfrom=(278.0, 278.0, -800.0),
        lookat=(278.0, 278.0, 0.0), defocus_angle=2.0, focus_dist=800.0,
    )


# name -> (scene, camera, chunk x0, y0, width, height, spp, bounces, rand key);
# rand = jax.random.uniform(PRNGKey(key), (spp, n_uniforms(bounces), w*h))
MEGAKERNEL_GOLDENS = {
    "prism_megakernel_24px.npy": (PRISM, lambda: scene_camera(PRISM, 24, 24), 0, 0, 24, 24, 4, 5, 11),
    "tris_megakernel_24px.npy": (TRIS, lambda: scene_camera(TRIS, 24, 24), 0, 0, 24, 24, 4, 4, 12),
    "cornell_thinlens_megakernel_24px.npy": (CORNELL, lambda: _thin_lens(24, 24), 0, 0, 24, 24, 4, 3, 13),
    "cornell_oddchunk_megakernel.npy": (CORNELL, lambda: scene_camera(CORNELL, 600, 600), 37, 101, 23, 17, 4, 4, 14),
    "prism_oddchunk_megakernel.npy": (PRISM, lambda: scene_camera(PRISM, 512, 512), 200, 300, 31, 9, 2, 10, 15),
}


def render_megakernel_golden(name, interpret=True):
    sid, cam, x0, y0, w, h, spp, bounces, key = MEGAKERNEL_GOLDENS[name]
    rand = jax.random.uniform(
        jax.random.PRNGKey(key), (spp, n_uniforms(bounces), w * h), jnp.float32
    )
    return np.asarray(
        render_chunk_pallas(
            build_scene(sid), cam(), 0, x0, y0, w, h, spp, bounces,
            interpret=interpret, rand=rand,
        )
    )


class TestGoldens:
    def test_cornell_xla(self):
        scene = build_scene(CORNELL)
        cam = scene_camera(CORNELL, 24, 24)
        img = np.asarray(
            render_chunk(scene, cam, jax.random.PRNGKey(123), 0, 0, 24, 24, 4, 3)
        )
        np.testing.assert_allclose(
            img, _golden("cornell_xla_24px.npy"), rtol=1e-5, atol=1e-6
        )

    def test_cornell_pallas_interpret(self):
        scene = build_scene(CORNELL)
        cam = scene_camera(CORNELL, 24, 24)
        # the uniforms this golden was written with: a 1024-wide array of
        # which the 576 pixels use the first columns
        rand = jax.random.uniform(
            jax.random.PRNGKey(42), (4, n_uniforms(3), 1024), jnp.float32
        )[:, :, :576]
        img = np.asarray(
            render_chunk_pallas(
                scene, cam, 9, 0, 0, 24, 24, 4, 3, interpret=True, rand=rand
            )
        )
        np.testing.assert_allclose(
            img, _golden("cornell_pallas_24px.npy"), rtol=1e-5, atol=1e-6
        )

    @pytest.mark.parametrize("name", sorted(MEGAKERNEL_GOLDENS))
    def test_megakernel_interpret(self, name):
        np.testing.assert_allclose(
            render_megakernel_golden(name), _golden(name), rtol=1e-5, atol=1e-6
        )

    def test_prism_xla(self):
        scene = build_scene(PRISM)
        cam = scene_camera(PRISM, 24, 24)
        img = np.asarray(
            render_chunk(scene, cam, jax.random.PRNGKey(7), 0, 0, 24, 24, 4, 5)
        )
        np.testing.assert_allclose(
            img, _golden("prism_xla_24px.npy"), rtol=1e-5, atol=1e-6
        )
