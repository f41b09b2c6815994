"""jax.grad of the XLA wavefront against finite differences, per scene and
parameter family.

Every gradient of the system is autodiff of render/wavefront.py. Material
coefficients, emission powers and the background spectrum never change a
path's geometry, so with common random numbers (one fixed key) the render
is a smooth function of them and a central finite difference must match
the directional derivative (the tolerance of
tests/test_diff.py::TestMaterialGradients). The 520-triangle field runs
the LBVH path (models/scenes.py::auto_bvh), whose traversal carries no
tangents.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectral_tpu.models.scenes import (
    CORNELL,
    PRISM,
    TRIS,
    build_scene,
    build_tri_field,
    scene_camera,
)
from spectral_tpu.ops.rgb2spec import srgb_to_illuminance_spectrum
from spectral_tpu.render.wavefront import render_chunk

SIZE, SPP, BOUNCES, EPS = 16, 4, 4, 1e-3


def _scene(name):
    scene = {
        "prism": lambda: build_scene(PRISM),
        "tris": lambda: build_scene(TRIS),
        "field520": lambda: build_tri_field(520, seed=3),
    }[name]()
    # a gray sky so escaping paths carry weight (black would zero the
    # background gradient)
    return dataclasses.replace(
        scene,
        background_spd=srgb_to_illuminance_spectrum(jnp.asarray([0.5, 0.5, 0.5])),
    )


def _with(scene, family, value):
    if family == "background":
        return dataclasses.replace(scene, background_spd=value)
    from spectral_tpu.models.materials import tabulate

    mats = dataclasses.replace(scene.materials, **{family: value})
    return dataclasses.replace(scene, materials=tabulate(mats))


def _value(scene, family):
    if family == "background":
        return scene.background_spd
    return getattr(scene.materials, family)


def _direction(family, x):
    if family == "coeffs":
        return jnp.zeros_like(x).at[:, 2].set(1.0)  # every material's c2
    return jnp.ones_like(x)


@pytest.mark.parametrize(
    "scene_name,family",
    [
        ("prism", "coeffs"),
        ("prism", "background"),
        ("tris", "coeffs"),
        ("tris", "emission_power"),
        ("field520", "emission_power"),
        ("field520", "background"),
    ],
)
def test_grad_matches_crn_fd(scene_name, family):
    scene = _scene(scene_name)
    sid = CORNELL if scene_name == "field520" else {"prism": PRISM, "tris": TRIS}[scene_name]
    cam = scene_camera(sid, SIZE, SIZE)
    key = jax.random.PRNGKey(11)
    x0 = _value(scene, family)
    direction = _direction(family, x0)

    def loss(x):
        img = render_chunk(_with(scene, family, x), cam, key, 0, 0, SIZE, SIZE, SPP, BOUNCES)
        return jnp.mean(img[..., 1])

    ad = float(jnp.vdot(jax.grad(loss)(x0), direction))
    fd = float(loss(x0 + EPS * direction) - loss(x0 - EPS * direction)) / (2 * EPS)
    assert np.isfinite(ad) and np.isfinite(fd)
    assert abs(ad) > 0.0, (scene_name, family)
    assert abs(ad - fd) <= 0.05 * max(abs(ad), abs(fd)) + 1e-7, (ad, fd)
