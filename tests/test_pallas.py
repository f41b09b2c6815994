"""Megakernel tests through the Pallas interpreter on CPU.

The kernel is compiled for the GPU only on a card (chip_smoke.py phase 5);
here it runs in interpret mode, which executes the same kernel body. With
injected uniforms it is a fixed function of them: padding and block size
must not change any ray's result, and the goldens of tests/test_goldens.py
pin it to the images the previous megakernel produced. With its own
counter-hash stream it must agree with the XLA wavefront statistically
(same estimator, different random numbers).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectral_tpu.models.scenes import CORNELL, build_scene, build_tri_field, scene_camera
from spectral_tpu.ops.pallas.render_kernel import (
    _bits_to_uniform,
    _hash32,
    camera_vector,
    n_uniforms,
    pack_scene,
    render_chunk_pallas,
    render_rays_pallas,
)
from spectral_tpu.render.wavefront import render_chunk


@pytest.fixture(scope="module")
def cornell():
    return build_scene(CORNELL)


class TestMegakernel:
    def test_statistical_match_vs_xla(self, cornell):
        cam = scene_camera(CORNELL, 32, 32)
        spp, bounces = 16, 4
        xyz_p = np.asarray(
            render_chunk_pallas(
                cornell, cam, 7, 0, 0, 32, 32, spp, bounces, interpret=True,
            )
        )
        xyz_x = np.asarray(
            render_chunk(cornell, cam, jax.random.PRNGKey(7), 0, 0, 32, 32, spp, bounces)
        )
        assert np.isfinite(xyz_p).all()
        mp = xyz_p[..., 1].mean()
        mx = xyz_x[..., 1].mean()
        # different random streams: MC noise at 16 spp puts the mean within
        # ~15-20%; the exact oracle is the injected-uniform goldens
        assert abs(mp - mx) / max(mx, 1e-9) < 0.2
        corr = np.corrcoef(xyz_p[..., 1].ravel(), xyz_x[..., 1].ravel())[0, 1]
        assert corr > 0.85

    def test_deterministic_with_injected_rand(self, cornell):
        cam = scene_camera(CORNELL, 16, 16)
        rand = jax.random.uniform(jax.random.PRNGKey(1), (4, n_uniforms(3), 256))
        a = render_chunk_pallas(cornell, cam, 3, 0, 0, 16, 16, 4, 3, interpret=True, rand=rand)
        b = render_chunk_pallas(cornell, cam, 3, 0, 0, 16, 16, 4, 3, interpret=True, rand=rand)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_defocus_camera_renders(self, cornell):
        """Thin-lens defocus in the megakernel (defocus_disk_sample,
        rendering.cu:42-47): origins spread over the lens disk -> finite
        image; camera_vector flags it."""
        from spectral_tpu.models.camera import make_camera

        cam = make_camera(
            16, 16, vfov=40.0, lookfrom=(278.0, 278.0, -800.0),
            lookat=(278.0, 278.0, 0.0), defocus_angle=2.0, focus_dist=800.0,
        )
        vec = camera_vector(cam)
        assert float(vec[18]) == 1.0
        xyz = render_chunk_pallas(cornell, cam, 3, 0, 0, 16, 16, 4, 2, interpret=True)
        assert np.isfinite(np.asarray(xyz)).all()

    def test_n_uniforms(self):
        assert n_uniforms(0) == 5
        assert n_uniforms(4) == 17


class TestPaddingAndBlock:
    """Ray counts that are not a multiple of the block: the wrapper pads,
    and every real ray's result is the one it gets inside a full block."""

    SPP, BOUNCES, WIDTH, ROW = 2, 3, 1024, 512

    @pytest.fixture(scope="class")
    def reference(self, cornell):
        cam = scene_camera(CORNELL, self.WIDTH, self.WIDTH)
        rand = jax.random.uniform(
            jax.random.PRNGKey(5), (self.SPP, n_uniforms(self.BOUNCES), self.WIDTH)
        )
        ref = render_chunk_pallas(
            cornell, cam, 0, 0, self.ROW, self.WIDTH, 1, self.SPP, self.BOUNCES,
            interpret=True, rand=rand,
        )
        return cam, rand, np.asarray(ref)[0]

    @pytest.mark.parametrize("block", [64, 128])
    @pytest.mark.parametrize("n", [1, 127, 129, 1000])
    def test_padded_rays_match_full_block(self, cornell, reference, n, block):
        cam, rand, ref = reference
        out = render_chunk_pallas(
            cornell, cam, 0, 0, self.ROW, n, 1, self.SPP, self.BOUNCES,
            block=block, interpret=True, rand=rand[:, :, :n],
        )
        out = np.asarray(out)
        assert out.shape == (1, n, 3)
        np.testing.assert_allclose(out[0], ref[:n], rtol=1e-6, atol=1e-7)
        assert ref[:n].max() > 0.0 or n == 1


class TestWrapperContract:
    def test_ray_count_must_divide_block(self, cornell):
        cam = scene_camera(CORNELL, 8, 8)
        tri, mat, tab = pack_scene(cornell)
        px = jnp.zeros((100,), jnp.float32)
        with pytest.raises(ValueError, match="block"):
            render_rays_pallas(camera_vector(cam), 0, tri, mat, tab, px, px, 1, 1, 64, True)
        px = jnp.zeros((96,), jnp.float32)
        with pytest.raises(ValueError, match="block"):
            render_rays_pallas(camera_vector(cam), 0, tri, mat, tab, px, px, 1, 1, 96, True)

    def test_rand_shape_checked(self, cornell):
        cam = scene_camera(CORNELL, 8, 8)
        rand = jnp.zeros((2, n_uniforms(2), 63))
        with pytest.raises(ValueError, match="rand shape"):
            render_chunk_pallas(cornell, cam, 0, 0, 0, 8, 8, 2, 2, interpret=True, rand=rand)

    def test_large_scene_refused(self):
        field = build_tri_field(264, seed=0)
        cam = scene_camera(CORNELL, 8, 8)
        with pytest.raises(ValueError, match="DENSE_CUTOFF"):
            render_chunk_pallas(field, cam, 0, 0, 0, 8, 8, 1, 1, interpret=True)


class TestCounterHashStream:
    def test_uniforms_are_uniform_and_decorrelated(self):
        """The in-kernel generator: u = top 24 bits of hash(key + ctr * phi)
        with key = hash(seed ^ hash(pixel)). Moments of U[0,1), no lag-1
        correlation along draws or between neighbouring pixels."""
        pix = jnp.arange(4096, dtype=jnp.int32)
        key = _hash32(jnp.int32(1984) ^ _hash32(pix))
        ctr = jnp.arange(64, dtype=jnp.uint32)[:, None]
        u = np.asarray(_bits_to_uniform(_hash32(key[None, :] + ctr * jnp.uint32(0x9E3779B9))))
        assert u.min() >= 0.0 and u.max() < 1.0
        assert abs(u.mean() - 0.5) < 0.005
        assert abs(u.var() - 1.0 / 12.0) < 0.002
        assert abs(np.corrcoef(u[:-1].ravel(), u[1:].ravel())[0, 1]) < 0.01
        assert abs(np.corrcoef(u[:, :-1].ravel(), u[:, 1:].ravel())[0, 1]) < 0.01

    def test_seed_changes_stream(self, cornell):
        cam = scene_camera(CORNELL, 16, 16)
        a = np.asarray(render_chunk_pallas(cornell, cam, 1, 0, 0, 16, 16, 2, 3, interpret=True))
        b = np.asarray(render_chunk_pallas(cornell, cam, 2, 0, 0, 16, 16, 2, 3, interpret=True))
        assert np.isfinite(a).all() and a.mean() > 0.0
        assert not np.array_equal(a, b)


class TestShardedPallas:
    def test_runs_on_8_device_mesh(self, cornell):
        """Megakernel under shard_map on the virtual mesh (interpret mode):
        validates sharding, per-shard seeds and the sample-axis psum."""
        from spectral_tpu.parallel import make_mesh, render_image_sharded_pallas

        cam = scene_camera(CORNELL, 16, 32)
        xyz = render_image_sharded_pallas(cornell, cam, 5, make_mesh(8), 4, 2, interpret=True)
        assert xyz.shape == (32, 16, 3)
        assert np.isfinite(np.asarray(xyz)).all()
