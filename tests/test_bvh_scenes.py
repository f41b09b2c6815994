"""LBVH on the system's own scenes: traversal against the dense
intersector, and the rule that attaches an LBVH above DENSE_CUTOFF
(models/scenes.py::auto_bvh). tests/test_bvh.py covers random triangle
clouds; this file covers the reference scenes and the procedural field,
including its dielectric variant, at three leaf sizes."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from spectral_tpu.models.scenes import (
    CORNELL,
    PRISM,
    TRIS,
    auto_bvh,
    build_scene,
    build_tri_field,
    with_bvh,
)
from spectral_tpu.ops.bvh import nearest_hit_bvh
from spectral_tpu.ops.intersect import nearest_hit
from spectral_tpu.utils.constants import DENSE_CUTOFF

SCENES = {
    "cornell": lambda: build_scene(CORNELL),
    "prism": lambda: build_scene(PRISM),
    "tris": lambda: build_scene(TRIS),
    "field520": lambda: build_tri_field(520, seed=3),
    "field520_glass": lambda: build_tri_field(520, seed=4, glass=True),
}


def _rays(n=1024, seed=0):
    """Camera-like rays from in front of the box plus rays from inside it
    in every direction (the secondary bounces)."""
    rng = np.random.default_rng(seed)
    half = n // 2
    o_cam = np.tile([278.0, 278.0, -800.0], (half, 1))
    target = rng.uniform([0, 0, 0], [555, 555, 555], (half, 3))
    o_in = rng.uniform(5.0, 550.0, (n - half, 3))
    d_in = rng.normal(size=(n - half, 3))
    o = np.concatenate([o_cam, o_in])
    d = np.concatenate([target - o_cam, d_in])
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


@pytest.mark.parametrize("leaf_size", [4, 8, 32])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_lbvh_matches_dense(name, leaf_size):
    scene = SCENES[name]()
    accel = with_bvh(scene, leaf_size=leaf_size)
    o, d = _rays()
    ref = nearest_hit(o, d, scene)
    got = nearest_hit_bvh(o, d, accel, accel.bvh)
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(np.asarray(got.hit), hit)
    assert hit.mean() > 0.5
    np.testing.assert_allclose(np.asarray(got.t)[hit], np.asarray(ref.t)[hit], rtol=1e-5)
    # the index may differ only at exact t ties (a ray through the shared
    # edge of a quad's two triangles), which the t check above covers
    same = np.asarray(got.tri_index)[hit] == np.asarray(ref.tri_index)[hit]
    assert same.mean() >= 0.99, same.mean()


def test_auto_bvh_attaches_above_cutoff():
    field = build_tri_field(264, seed=0)
    assert field.bvh is None and field.num_tris > DENSE_CUTOFF
    accel = auto_bvh(field)
    assert accel.bvh is not None and accel.bvh.n_tris == field.num_tris
    assert auto_bvh(accel) is accel  # an attached BVH is kept


def test_auto_bvh_leaves_dense_scenes():
    for sid in (CORNELL, PRISM, TRIS):
        scene = build_scene(sid)
        assert scene.num_tris <= DENSE_CUTOFF
        assert auto_bvh(scene) is scene
