"""Multi-device sharding tests on the virtual 8-device CPU mesh.

SURVEY.md section 4 anchor 4: the N-host path must run in CI on one process
via ``--xla_force_host_platform_device_count``. These tests exercise the
shard_map tile/sample decomposition, the sample-axis psum, and the gradient
all-reduce (psum transpose) through the full renderer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectral_tpu.models.scenes import CORNELL, build_scene, scene_camera
from spectral_tpu.parallel import (
    apply_params,
    factor_devices,
    make_mesh,
    render_image_sharded,
    train_step,
    trainable_params,
)


class TestMesh:
    def test_factor_devices(self):
        assert factor_devices(8) == (4, 2)
        assert factor_devices(4) == (2, 2)
        assert factor_devices(7) == (7, 1)
        assert factor_devices(1) == (1, 1)

    def test_make_mesh_shape(self):
        mesh = make_mesh(8)
        assert mesh.shape["tile"] * mesh.shape["sample"] == 8


@pytest.fixture(scope="module")
def cornell():
    return build_scene(CORNELL)


class TestShardedRender:
    def test_shape_finite_deterministic(self, cornell):
        mesh = make_mesh(8)
        cam = scene_camera(CORNELL, 16, 32)
        key = jax.random.PRNGKey(7)
        a = render_image_sharded(cornell, cam, key, mesh, spp := 4, 2)
        b = render_image_sharded(cornell, cam, key, mesh, spp, 2)
        assert a.shape == (32, 16, 3)
        assert np.isfinite(np.asarray(a)).all()
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_indivisible_raises(self, cornell):
        mesh = make_mesh(8)  # 4 x 2
        cam = scene_camera(CORNELL, 16, 30)  # 30 rows not divisible by 4
        with pytest.raises(ValueError):
            render_image_sharded(cornell, cam, jax.random.PRNGKey(0), mesh, 4, 2)

    def test_statistics_match_single_device(self, cornell):
        """Sharded and unsharded renders are the same Monte Carlo estimator:
        image means agree within MC tolerance."""
        cam = scene_camera(CORNELL, 16, 16)
        key = jax.random.PRNGKey(3)
        spp, bounces = 64, 4
        img8 = np.asarray(
            render_image_sharded(cornell, cam, key, make_mesh(8), spp, bounces)
        ) / spp
        img1 = np.asarray(
            render_image_sharded(cornell, cam, key, make_mesh(1), spp, bounces)
        ) / spp
        # Y-channel mean relative difference
        m8, m1 = img8[..., 1].mean(), img1[..., 1].mean()
        assert abs(m8 - m1) / max(m1, 1e-9) < 0.15


class TestTrainStep:
    def test_loss_finite_and_params_move(self, cornell):
        mesh = make_mesh(8)
        cam = scene_camera(CORNELL, 16, 32)
        key = jax.random.PRNGKey(0)
        spp, bounces = 4, 2
        target = (
            render_image_sharded(cornell, cam, key, mesh, spp, bounces) / spp
        )

        # perturb the red wall color; gradient should move coeffs back
        params = trainable_params(cornell)
        params["coeffs"] = params["coeffs"].at[0].add(0.3)

        new_params, loss = train_step(
            params, cornell, cam, target, jax.random.fold_in(key, 1),
            mesh, spp, bounces, lr=1e-2,
        )
        assert np.isfinite(float(loss)) and float(loss) > 0.0
        moved = np.abs(
            np.asarray(new_params["coeffs"]) - np.asarray(params["coeffs"])
        ).max()
        assert moved > 0.0

    def test_apply_params_roundtrip(self, cornell):
        params = trainable_params(cornell)
        scene2 = apply_params(cornell, params)
        np.testing.assert_allclose(
            np.asarray(scene2.materials.spd),
            np.asarray(cornell.materials.spd),
            rtol=1e-6,
        )

    def test_vertex_params_on_mesh(self, cornell):
        """Vertex leaves + warped-area estimator through the sharded
        train step: loss finite, vertex gradients finite and the
        perturbed vertices move (gradient numerics are CRN-FD-covered in
        tests/test_diff.py::TestVertexWarp; this pins the mesh path)."""
        mesh = make_mesh(8)
        cam = scene_camera(CORNELL, 16, 32)
        key = jax.random.PRNGKey(2)
        spp, bounces = 4, 2
        target = (
            render_image_sharded(cornell, cam, key, mesh, spp, bounces) / spp
        )
        params = trainable_params(cornell, include_vertices=True)
        shift = jnp.zeros_like(params["v0"]).at[24:36].add(
            jnp.array([20.0, 0.0, 0.0])
        )
        for k in ("v0", "v1", "v2"):
            params[k] = params[k] + shift

        new_params, loss = train_step(
            params, cornell, cam, target, jax.random.fold_in(key, 3),
            mesh, spp, bounces, lr=1e3, vertex_warp=True,
        )
        assert np.isfinite(float(loss)) and float(loss) > 0.0
        for k in ("v0", "v1", "v2"):
            g = np.asarray(new_params[k]) - np.asarray(params[k])
            assert np.all(np.isfinite(g)), k


def test_dryrun_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


class TestFourDeviceMesh:
    """The (2, 2) mesh four cards take, on four of the virtual devices."""

    def test_render_on_2x2_mesh(self, cornell):
        mesh = make_mesh(4)
        assert dict(mesh.shape) == {"tile": 2, "sample": 2}
        cam = scene_camera(CORNELL, 16, 16)
        key = jax.random.PRNGKey(4)
        img4 = render_image_sharded(cornell, cam, key, mesh, 32, 3)
        assert img4.shape == (16, 16, 3)
        assert len(img4.sharding.device_set) == 4
        img1 = render_image_sharded(cornell, cam, key, make_mesh(1), 32, 3)
        m4 = float(np.asarray(img4)[..., 1].mean())
        m1 = float(np.asarray(img1)[..., 1].mean())
        assert m1 > 0.0 and abs(m4 - m1) / m1 < 0.15

    def test_train_step_on_2x2_mesh(self, cornell):
        mesh = make_mesh(4)
        cam = scene_camera(CORNELL, 16, 16)
        key = jax.random.PRNGKey(5)
        target = render_image_sharded(cornell, cam, key, mesh, 4, 2) / 4
        params = trainable_params(cornell)
        params["coeffs"] = params["coeffs"].at[0].add(0.3)
        new_params, loss = train_step(
            params, cornell, cam, target, jax.random.fold_in(key, 1),
            mesh, 4, 2, lr=1e-2,
        )
        assert np.isfinite(float(loss)) and float(loss) > 0.0
        for k, v in new_params.items():
            assert np.isfinite(np.asarray(v)).all(), k
        assert np.abs(np.asarray(new_params["coeffs"] - params["coeffs"])).max() > 0.0
