"""Differentiability tests: autodiff vs finite differences (BASELINE
config 5; SURVEY.md section 4 item 3 — the reference has no gradients, the
FD oracle is the acceptance test for the new capability).

The gradient policy detaches discrete decisions (hit selection, Schlick
branch, material one-hot), so AD computes the derivative of the
*continuous* part of the estimator. With a FIXED rng key the renderer is a
deterministic function of the parameters; FD matches AD up to the measure
of rays whose discrete decisions flip inside the FD step — tolerances are
set accordingly (loose rtol, tiny eps, averaged over many rays).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spectral_tpu.diff import derive_tri_arrays, scene_with_vertices
from spectral_tpu.models.scenes import CORNELL, PRISM, build_scene, scene_camera
from spectral_tpu.parallel import apply_params, trainable_params
from spectral_tpu.render.wavefront import render_tile_xyz


@pytest.fixture(scope="module")
def cornell():
    return build_scene(CORNELL)


@pytest.fixture(scope="module")
def prism():
    return build_scene(PRISM)


class TestDeriveTriArrays:
    @pytest.mark.parametrize("sid", [CORNELL, PRISM])
    def test_matches_host_finalize(self, sid):
        """jnp derivation == numpy finalize on the real scenes."""
        scene = build_scene(sid)
        arrs = derive_tri_arrays(scene.v0, scene.v1, scene.v2)
        for k in ("normal", "d", "edge_g", "edge_c", "bbox_min", "bbox_max"):
            np.testing.assert_allclose(
                np.asarray(arrs[k]),
                np.asarray(getattr(scene, k)),
                rtol=2e-5,
                atol=2e-2,  # edge_c magnitudes reach ~3e5; abs slack is f32 eps-scale
                err_msg=k,
            )


def _pixel_grid(n):
    ys, xs = jnp.meshgrid(
        jnp.arange(n, dtype=jnp.int32), jnp.arange(n, dtype=jnp.int32), indexing="ij"
    )
    return xs.ravel(), ys.ravel()


def _fd_check(loss, p0, direction, eps, rtol, atol):
    """Directional derivative: AD grad . dir vs central finite difference."""
    g = jax.grad(loss)(p0)
    ad = float(jnp.vdot(g, direction))
    lp = float(loss(p0 + eps * direction))
    lm = float(loss(p0 - eps * direction))
    fd = (lp - lm) / (2.0 * eps)
    assert np.isfinite(ad) and np.isfinite(fd)
    assert abs(ad - fd) <= rtol * max(abs(ad), abs(fd)) + atol, (
        f"AD {ad} vs FD {fd}"
    )
    return ad, fd


def _sky_lit(scene):
    """Scene variant with a gray sky background so every escaping path
    carries spectral weight (keeps low-spp gradient tests well-fed; the
    gray uplift path is closed-form so no fit compile)."""
    from spectral_tpu.ops.rgb2spec import srgb_to_illuminance_spectrum

    return dataclasses.replace(
        scene, background_spd=srgb_to_illuminance_spectrum(jnp.asarray([0.8, 0.8, 0.8]))
    )


class TestMaterialGradients:
    def test_coeff_gradient_matches_fd(self, cornell):
        """d(mean luminance) / d(sigmoid coeffs of the white wall material):
        camera -> wall -> sky paths make the wall SPD a smooth factor."""
        scene = _sky_lit(cornell)
        cam = scene_camera(CORNELL, 16, 16)
        px, py = _pixel_grid(16)
        key = jax.random.PRNGKey(5)
        params0 = trainable_params(scene)

        def loss(coeffs):
            p = dict(params0, coeffs=coeffs)
            s = apply_params(scene, p)
            xyz = render_tile_xyz(s, cam, px, py, key, 4, 4)
            return jnp.mean(xyz[:, 1])

        # white wall material = index 3 in the cornell build order
        direction = jnp.zeros_like(params0["coeffs"]).at[3, 2].set(1.0)
        ad, fd = _fd_check(loss, params0["coeffs"], direction, 1e-3, 0.05, 1e-7)
        assert abs(ad) > 0.0  # the white walls are visible: gradient nonzero

    def test_emission_power_gradient_matches_fd(self, cornell):
        cam = scene_camera(CORNELL, 16, 16)
        px, py = _pixel_grid(16)
        key = jax.random.PRNGKey(6)
        params0 = trainable_params(cornell)

        def loss(power):
            p = dict(params0, emission_power=power)
            s = apply_params(cornell, p)
            xyz = render_tile_xyz(s, cam, px, py, key, 4, 4)
            return jnp.mean(xyz[:, 1])

        # light material is index 4 in the cornell build order
        direction = jnp.zeros_like(params0["emission_power"]).at[4].set(1.0)
        ad, fd = _fd_check(
            loss, params0["emission_power"], direction, 1e-3, 0.05, 1e-7
        )
        assert ad > 0.0  # more light power -> brighter image


class TestSellmeierGradients:
    """Exact Sellmeier B/C gradients via the hero-wavelength
    reparameterization (diff/spectral_reparam.py). Round 1 shipped a
    vacuous version of this test (AD = FD = 0.0 passing through the atol
    escape); these assert the gradient is NONZERO and unbiased.

    Matches /root/reference/materials/material.cu:73-80 (n(lambda) is the
    only B/C consumer) and refraction/sellmeier.cu:12-23."""

    GLASS = 2  # prism glass material row

    def _loss(self, prism, b_glass, key, reparam, frozen=None, spp=2, size=16):
        import dataclasses

        cam = scene_camera(PRISM, size, size)
        mats = prism.materials
        s = dataclasses.replace(
            prism,
            materials=dataclasses.replace(
                mats, sellmeier_b=mats.sellmeier_b.at[self.GLASS].set(b_glass)
            ),
        )
        from spectral_tpu.render.wavefront import render_chunk

        xyz = render_chunk(
            s, cam, key, 0, 0, size, size, spp, 6,
            reparam_glass=(self.GLASS if reparam else None),
            reparam_frozen=frozen,
        )
        return jnp.sum(xyz[..., 1])

    def test_map_is_measure_preserving_f64(self, prism):
        """The change of variables itself, in f64: E[f(T(l)) T'(l)] must
        equal E[f(l)] to second order in (b - b0) for band-limited f (the
        renderer's integrand class: CIE factors vanish at the seam). This
        is the property whose violation round 2 first measured as a
        gradient bias 2.5x the signal."""
        from spectral_tpu.diff.spectral_reparam import reparam_hero
        from spectral_tpu.utils.constants import LAMBDA_MAX, LAMBDA_MIN

        jax.config.update("jax_enable_x64", True)
        try:
            b0 = prism.materials.sellmeier_b[self.GLASS].astype(jnp.float64)
            c0 = prism.materials.sellmeier_c[self.GLASS].astype(jnp.float64)
            span = LAMBDA_MAX - LAMBDA_MIN
            n = 400_000
            lam0 = jnp.linspace(LAMBDA_MIN, LAMBDA_MAX, n, dtype=jnp.float64)

            def f(l):
                x = (l - LAMBDA_MIN) / span
                return jnp.sin(np.pi * x) ** 2 * (
                    1.0 + 0.5 * jnp.sin(6 * np.pi * x)
                )

            rhs = float(jnp.mean(f(lam0)))
            for db in (0.01, 0.02):
                b = b0 + jnp.asarray([db, 0.0, 0.0], lam0.dtype)
                hero, w = reparam_hero(lam0, b, c0, frozen=(b0, c0))
                hw = jnp.where(hero > LAMBDA_MAX, hero - span, hero)
                hw = jnp.where(hw < LAMBDA_MIN, hw + span, hw)
                err = abs(float(jnp.mean(f(hw) * w)) - rhs)
                # first-order violation would be ~1e-3 * db / 0.01 here
                assert err < 2e-6 + 40.0 * db**3, (db, err)
        finally:
            jax.config.update("jax_enable_x64", False)

    def test_primal_unchanged(self, prism):
        """Turning the reparameterization on must not change the rendered
        image at the primal point (the map is the identity there)."""
        key = jax.random.PRNGKey(7)
        b0 = prism.materials.sellmeier_b[self.GLASS]
        off = float(self._loss(prism, b0, key, reparam=False))
        on = float(self._loss(prism, b0, key, reparam=True))
        assert abs(on - off) <= 1e-5 * abs(off) + 1e-6, (on, off)

    @staticmethod
    def _slab_scene():
        """High-SNR dispersion test vehicle: a thin glass slab filling the
        camera frustum against a colorful sky, physically-sane flint C.
        Every path refracts, so every sample carries Sellmeier signal —
        unlike the prism scene, whose caustic paths make per-seed gradient
        variance ~100x the mean."""
        import dataclasses  # noqa: F401

        from spectral_tpu.models.geometry import TriSoup
        from spectral_tpu.models.materials import MaterialBuilder
        from spectral_tpu.models.scenes import _scene_from
        from spectral_tpu.utils.constants import (
            SELLMEIER_FLINT_GLASS_B,
            SELLMEIER_FLINT_GLASS_C,
        )

        mb = MaterialBuilder(replicate_reference_bugs=False)
        glass = mb.dielectric(
            np.asarray(SELLMEIER_FLINT_GLASS_B),
            np.asarray(SELLMEIER_FLINT_GLASS_C),
        )
        soup = TriSoup()
        soup.box((-400, -400, -220), (955, 955, -200), glass)
        return _scene_from(soup, mb.build(), background_rgb=(0.35, 0.55, 0.9)), glass

    def test_b_gradient_nonzero_and_matches_frozen_fd(self):
        """Statistical gold check on the slab scene: per-seed reparam AD is
        (a) nonzero — the plain estimator's AD is identically 0.0 — and
        (b) paired-consistent with the frozen-target finite difference of
        the same estimator (decision flips under the frozen target are
        O(eps^2), so per-seed FD is smooth and the PAIRED statistic is
        tight even though per-seed gradients are heavy-tailed)."""
        import dataclasses

        from spectral_tpu.render.wavefront import render_chunk

        scene, glass = self._slab_scene()
        size, spp = 8, 4
        cam = scene_camera(PRISM, size, size)
        b0 = scene.materials.sellmeier_b[glass]
        c0 = scene.materials.sellmeier_c[glass]
        e = jnp.zeros(3).at[0].set(1.0)
        eps = 1e-4

        def loss(bg, key, reparam=True, frozen=None):
            s = dataclasses.replace(
                scene,
                materials=dataclasses.replace(
                    scene.materials,
                    sellmeier_b=scene.materials.sellmeier_b.at[glass].set(bg),
                ),
            )
            xyz = render_chunk(
                s, cam, key, 0, 0, size, size, spp, 4,
                reparam_glass=(glass if reparam else None),
                reparam_frozen=frozen,
            )
            return jnp.sum(xyz)

        # the plain estimator: provably zero gradient (round-1 state)
        g_plain = jax.jit(jax.grad(lambda b, k: loss(b, k, reparam=False)))
        assert float(g_plain(b0, jax.random.PRNGKey(0))[0]) == 0.0

        g_fn = jax.jit(jax.grad(lambda b, k: loss(b, k)))
        fd_fn = jax.jit(lambda b, k: loss(b, k, frozen=(b0, c0)))
        K = 12
        ads, fds = [], []
        for i in range(K):
            k = jax.random.PRNGKey(100 + i)
            ads.append(float(g_fn(b0, k)[0]))
            fds.append(
                (float(fd_fn(b0 + eps * e, k)) - float(fd_fn(b0 - eps * e, k)))
                / (2 * eps)
            )
        ads = np.asarray(ads)
        fds = np.asarray(fds)
        # (a) nonzero per-seed: the old vacuous estimator gave exactly 0.0
        assert (np.abs(ads) > 0.0).mean() > 0.9, ads
        assert np.abs(ads).mean() > 1.0, ads
        # (b) paired-unbiased against the same function's FD
        d = ads - fds
        sem_d = d.std() / np.sqrt(K)
        assert abs(d.mean()) <= 4.0 * sem_d + 0.05 * np.abs(ads).mean(), (
            ads.mean(), fds.mean(), d.mean(), sem_d,
        )


class TestVertexGradients:
    """Vertex gradients flow through the SMOOTH geometric quantities of the
    selected hit (t, p, normal via the differentiable plane/edge derivation).
    Radiance itself is piecewise-constant in vertices for this estimator
    (spectral weights depend only on which material a path hits), so pure
    visibility gradients are zero a.e. — matching FD there needs
    edge-sampling/reparameterization, tracked as future work in
    diff/geometry.py. Geometry losses (depth, normals) are the honest
    oracle for the vertex-Jacobian machinery."""

    def test_depth_gradient_matches_fd(self, cornell):
        """d(mean hit depth)/d(global +y shift): every hit plane moves,
        mean depth changes smoothly -> FD matches AD."""
        from spectral_tpu.models.camera import generate_rays
        from spectral_tpu.ops.intersect import nearest_hit

        cam = scene_camera(CORNELL, 16, 16)
        px, py = _pixel_grid(16)
        key = jax.random.PRNGKey(8)
        o, d = generate_rays(cam, px, py, key)

        def loss(dy):
            shift = jnp.array([0.0, 1.0, 0.0]) * dy
            s = scene_with_vertices(
                cornell, cornell.v0 + shift, cornell.v1 + shift, cornell.v2 + shift
            )
            rec = nearest_hit(o, d, s)
            return jnp.mean(jnp.where(rec.hit, rec.t, 0.0))

        ad, fd = _fd_check(loss, jnp.float32(0.0), jnp.float32(1.0), 1e-2, 0.05, 1e-6)
        assert abs(ad) > 0.0

    def test_normal_gradient_matches_fd(self):
        """Tilting a (non-axis-aligned) triangle changes the selected-hit
        normal smoothly; a normal-alignment loss FD-matches. The triangle is
        tilted so its discrete projection tag is stable under the FD step
        (axis-aligned tris flip tags at +-eps — a detached discrete jump)."""
        import types

        from spectral_tpu.ops.intersect import nearest_hit

        # rays: small grid shooting +z
        g = jnp.linspace(0.5, 3.5, 8)
        ox, oy = jnp.meshgrid(g, g, indexing="ij")
        o = jnp.stack([ox.ravel(), oy.ravel(), jnp.zeros(64)], -1)
        d = jnp.broadcast_to(jnp.asarray([0.05, 0.08, 1.0]), (64, 3))
        up = jnp.array([0.0, 1.0, 0.0])

        def loss(dx):
            v0 = jnp.asarray([[-10.0, -10.0, 4.0]])
            v1 = jnp.asarray([[20.0 + dx, -10.0, 5.0 + dx]])
            v2 = jnp.asarray([[-10.0, 20.0, 6.0]])
            arrs = derive_tri_arrays(v0, v1, v2)
            s = types.SimpleNamespace(mat_index=jnp.zeros(1, jnp.int32), **arrs)
            rec = nearest_hit(o, d, s)
            align = jnp.sum(rec.normal * up, axis=-1)
            return jnp.mean(jnp.where(rec.hit, align, 0.0))

        ad, fd = _fd_check(loss, jnp.float32(0.0), jnp.float32(1.0), 1e-2, 0.05, 1e-6)
        assert abs(ad) > 0.0

    def test_radiance_vertex_gradient_finite(self, cornell):
        """Through the full renderer the vertex gradient must at least be
        finite and well-shaped (zero a.e. is expected — see class doc)."""
        cam = scene_camera(CORNELL, 8, 8)
        px, py = _pixel_grid(8)
        key = jax.random.PRNGKey(9)

        def loss(v):
            s = scene_with_vertices(cornell, v["v0"], v["v1"], v["v2"])
            xyz = render_tile_xyz(s, cam, px, py, key, 2, 3)
            return jnp.mean(xyz[:, 1])

        g = jax.grad(loss)({"v0": cornell.v0, "v1": cornell.v1, "v2": cornell.v2})
        for k, gv in g.items():
            assert gv.shape == (cornell.num_tris, 3)
            assert np.isfinite(np.asarray(gv)).all(), k


class TestVertexWarp:
    """Exact vertex-position gradients via the warped-area estimator
    (diff/vertex_warp.py). The plain estimator's vertex gradient is zero
    a.e. (geometry only selects which materials a path multiplies); the
    warp composes each sampled domain (camera pixel, lambertian bounce
    direction) with an edge-built field whose determinant carries the
    silhouette boundary terms.

    Ground truths were measured offline with large-K common-random-number
    central differences of the PLAIN estimator (the warp's job is to make
    AD match those expectation derivatives):
      - screen scene: FD = -4737 +- 9   (K=512 pairs, eps=0.05..0.2 stable)
      - shadow scene: FD = -934 +- 23   (K=256 pairs, eps=0.1)
      - all-diffuse Cornell, rademacher-weighted loss, box2 +x translation:
        FD = +0.0710 +- 0.0089 (K=8192 pairs, eps=3.0)
    Tolerances: the screen scene is deliberately pathological (its
    silhouette spans the full frame and exits both image borders, where
    the border-pinning edges dilute the warp within ~1px) — a ~2%
    deficit is expected and documented in vertex_warp.py."""

    @staticmethod
    def _screen_scene():
        from spectral_tpu.models.camera import make_camera
        from spectral_tpu.models.geometry import TriSoup
        from spectral_tpu.models.materials import MaterialBuilder
        from spectral_tpu.models.scenes import _scene_from

        mb = MaterialBuilder()
        dark = mb.lambertian((0.1, 0.1, 0.1))
        light = mb.emissive((1.0, 1.0, 1.0), 4.0)
        soup = TriSoup()
        soup.quad((-4.0, -4.0, 3.0), (8.0, 0.0, 0.0), (0.0, 8.0, 0.0), light)
        soup.quad((-3.0, -2.0, 1.0), (3.0, 0.0, 0.0), (0.0, 4.0, 0.0), dark)
        scene = _scene_from(soup, mb.build(), (0.0, 0.0, 0.0))
        cam = make_camera(16, 16, vfov=60.0, lookfrom=(0, 0, -2), lookat=(0, 0, 0))
        return scene, cam, 2  # occluder tris start at index 2

    @staticmethod
    def _shadow_scene():
        from spectral_tpu.models.camera import make_camera
        from spectral_tpu.models.geometry import TriSoup
        from spectral_tpu.models.materials import MaterialBuilder
        from spectral_tpu.models.scenes import _scene_from

        mb = MaterialBuilder()
        white = mb.lambertian((0.8, 0.8, 0.8))
        dark = mb.lambertian((0.05, 0.05, 0.05))
        light = mb.emissive((1.0, 1.0, 1.0), 6.0)
        soup = TriSoup()
        soup.quad((-4.0, 0.0, -4.0), (8.0, 0.0, 0.0), (0.0, 0.0, 8.0), white)
        soup.quad((-1.0, 3.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), light)
        soup.quad((-2.0, 1.5, -1.5), (2.0, 0.0, 0.0), (0.0, 0.0, 3.0), dark)
        scene = _scene_from(soup, mb.build(), (0.0, 0.0, 0.0))
        cam = make_camera(
            16, 16, vfov=70.0, lookfrom=(0.0, 1.0, -3.0), lookat=(0.0, 0.0, 0.5)
        )
        return scene, cam, 4

    @staticmethod
    def _make_loss(scene, cam, first_occ_tri, bounces, warp):
        from spectral_tpu.diff.vertex_warp import edges_from_vertices

        v0, v1, v2 = scene.v0, scene.v1, scene.v2
        mask = (jnp.arange(v0.shape[0]) >= first_occ_tri)[:, None].astype(
            jnp.float32
        )
        dir3 = jnp.array([1.0, 0.0, 0.0])
        px, py = _pixel_grid(16)

        def loss(th, key):
            dv = th * dir3 * mask
            s = scene_with_vertices(scene, v0 + dv, v1 + dv, v2 + dv)
            vw = edges_from_vertices(v0 + dv, v1 + dv, v2 + dv) if warp else None
            xyz = render_tile_xyz(s, cam, px, py, key, 4, bounces, vertex_warp=vw)
            return jnp.sum(xyz[:, 1])

        return loss

    def test_primal_identity(self, cornell):
        """V == 0 and det == 1 at the unperturbed parameters: the warp
        displaces nothing. Pixel values may deviate at f32-rounding level
        only, because the sphere warp normalizes the sampled lambertian
        direction (same ray, different scale bits downstream)."""
        from spectral_tpu.diff.vertex_warp import edges_from_vertices

        cam = scene_camera(CORNELL, 16, 16)
        px, py = _pixel_grid(16)
        key = jax.random.PRNGKey(11)
        base = render_tile_xyz(cornell, cam, px, py, key, 2, 3)
        edges = edges_from_vertices(cornell.v0, cornell.v1, cornell.v2)
        warped = render_tile_xyz(
            cornell, cam, px, py, key, 2, 3, vertex_warp=edges
        )
        assert float(jnp.max(jnp.abs(base - warped))) < 2e-5

    def test_screen_silhouette_gradient(self):
        """Primary-visibility boundary term (screen warp): AD within the
        documented band of the offline FD truth -4737 +- 9."""
        scene, cam, occ = self._screen_scene()
        loss = self._make_loss(scene, cam, occ, bounces=2, warp=True)
        g = jax.jit(jax.grad(loss))
        K = 48
        ads = np.array([float(g(0.0, jax.random.PRNGKey(i))) for i in range(K)])
        assert np.all(np.isfinite(ads))
        mean = ads.mean()
        sem = ads.std() / np.sqrt(K)
        # nonvacuous: significantly nonzero, right sign
        assert mean < 0 and abs(mean) > 5 * sem, (mean, sem)
        # magnitude: within [0.90, 1.06] of the FD truth (border-crossing
        # dilution documented at ~2%), allowing 3-sigma of this run
        lo, hi = 0.90 * 4737 - 3 * sem, 1.06 * 4737 + 3 * sem
        assert lo <= -mean <= hi, (mean, sem)

    def test_shadow_gradient(self):
        """Lambertian-bounce boundary term (direction warp): the occluder
        shadow. Offline FD truth -934 +- 23."""
        scene, cam, occ = self._shadow_scene()
        loss = self._make_loss(scene, cam, occ, bounces=3, warp=True)
        g = jax.jit(jax.grad(loss))
        K = 48
        ads = np.array([float(g(0.0, jax.random.PRNGKey(i))) for i in range(K)])
        assert np.all(np.isfinite(ads))
        mean = ads.mean()
        sem = ads.std() / np.sqrt(K)
        assert mean < 0 and abs(mean) > 3 * sem, (mean, sem)
        lo, hi = 0.80 * 934 - 3 * sem, 1.20 * 934 + 3 * sem
        assert lo <= -mean <= hi, (mean, sem)

    def test_plain_estimator_vertex_grad_is_zero(self):
        """Contrast case: WITHOUT the warp, the same loss has zero AD
        gradient a.e. — documents why the warp is needed at all."""
        scene, cam, occ = self._screen_scene()
        loss = self._make_loss(scene, cam, occ, bounces=2, warp=False)
        g = float(jax.grad(loss)(0.0, jax.random.PRNGKey(0)))
        assert g == 0.0

    def test_nonrigid_single_corner(self):
        """The sphere warp is exact for NON-RIGID vertex motion too
        (per-edge velocities varying along the edge): one corner of a
        quad light skews while the others stay. All earlier validations
        translated whole objects (uniform per-edge velocity), which
        cancels a class of potential internal-flux errors — this pins
        the general case. Offline CRN-FD truth on this configuration:
        +0.0403 +- 0.0010; module AD measured +0.0400 +- 0.0003
        (scratch/proto_lamb_nonrigid.py)."""
        from spectral_tpu.diff.vertex_warp import (
            EdgeSet,
            warp_directions,
        )

        sg = jax.lax.stop_gradient
        o = jnp.array([0.0, 0.0, 0.0])
        n = jnp.array([0.0, 1.0, 0.0])
        ZH, XE = 0.6, 0.5

        def edge_set(th):
            c1 = jnp.array([XE + th, 2.0, ZH])  # moving corner
            c2 = jnp.array([XE, 2.0, -ZH])
            c3 = jnp.array([-1.5, 2.0, -ZH])
            c4 = jnp.array([-1.5, 2.0, ZH])
            return EdgeSet(
                a=jnp.stack([c2, c1, c4, c3]), b=jnp.stack([c1, c4, c3, c2])
            )

        def lit(w, th):
            t = 2.0 / jnp.maximum(w[..., 1], 1e-6)
            x = w[..., 0] * t
            z = w[..., 2] * t
            xe = XE + th * (z + ZH) / (2 * ZH)  # skewed right edge
            return (
                (x <= xe) & (jnp.abs(z) <= ZH) & (x >= -1.5) & (w[..., 1] > 0)
            ).astype(jnp.float32)

        def cosine_sample(key, nrm, N):
            k1, k2 = jax.random.split(key)
            u1 = jax.random.uniform(k1, (N,))
            u2 = jax.random.uniform(k2, (N,))
            rr = jnp.sqrt(u1)
            phi = 2 * jnp.pi * u2
            t1 = jnp.array([1.0, 0.0, 0.0])
            t2 = jnp.array([0.0, 0.0, 1.0])
            z = jnp.sqrt(jnp.maximum(1 - u1, 0.0))
            return (
                (rr * jnp.cos(phi))[:, None] * t1
                + (rr * jnp.sin(phi))[:, None] * t2
                + z[:, None] * nrm
            )

        def loss(th, key, N=20000):
            w0 = cosine_sample(key, sg(n), N)
            on = jnp.broadcast_to(o, (N, 3))
            nn = jnp.broadcast_to(n, (N, 3))
            wp, factor = warp_directions(on, nn, w0, edge_set(th))
            return jnp.mean(lit(wp, th) * factor)

        g = jax.jit(jax.grad(loss))
        K = 12
        ads = np.array([float(g(0.0, jax.random.PRNGKey(i))) for i in range(K)])
        assert np.all(np.isfinite(ads))
        mean = ads.mean()
        sem = ads.std() / np.sqrt(K)
        truth = 0.0403
        assert mean > 0 and mean > 5 * sem, (mean, sem)
        assert abs(mean - truth) < 0.15 * truth + 3 * sem, (mean, sem)


class TestSpecularChainGuard:
    """Runtime guard for the vertex-gradient estimator's documented blind
    spot (round-4): silhouettes seen only through metal/dielectric chains
    carry no boundary term. When vertex_warp is active and the fraction
    of contributing paths that crossed a specular bounce exceeds
    SPECULAR_WARN_FRAC, render_tile_xyz must emit a warning."""

    @staticmethod
    def _mirror_scene():
        from spectral_tpu.models.geometry import TriSoup
        from spectral_tpu.models.materials import MaterialBuilder
        from spectral_tpu.models.scenes import _scene_from

        mb = MaterialBuilder(replicate_reference_bugs=False)
        mirror = mb.metallic((0.9, 0.9, 0.9), fuzz=0.0)
        soup = TriSoup()
        # a mirror slab filling the camera frustum: every contributing
        # path bounces off metal before reaching the background
        soup.box((-400, -400, -220), (955, 955, -200), mirror)
        return _scene_from(soup, mb.build(), background_rgb=(0.5, 0.6, 0.8))

    def test_mirror_scene_trips_warning(self):
        import warnings

        from spectral_tpu.diff.vertex_warp import edges_from_vertices
        from spectral_tpu.render.wavefront import render_tile_xyz

        scene = self._mirror_scene()
        cam = scene_camera(PRISM, 16, 16)
        px, py = _pixel_grid(16)
        edges = edges_from_vertices(scene.v0, scene.v1, scene.v2)
        with pytest.warns(UserWarning, match="specular"):
            jax.block_until_ready(
                render_tile_xyz(
                    scene, cam, px, py, jax.random.PRNGKey(2), 2, 3,
                    vertex_warp=edges,
                )
            )

    def test_diffuse_scene_is_silent(self, cornell):
        import warnings

        from spectral_tpu.diff.vertex_warp import edges_from_vertices
        from spectral_tpu.render.wavefront import render_tile_xyz

        cam = scene_camera(CORNELL, 16, 16)
        px, py = _pixel_grid(16)
        edges = edges_from_vertices(cornell.v0, cornell.v1, cornell.v2)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            jax.block_until_ready(
                render_tile_xyz(
                    cornell, cam, px, py, jax.random.PRNGKey(2), 2, 3,
                    vertex_warp=edges,
                )
            )
        assert not [w for w in rec if "specular" in str(w.message)], rec


class TestFuzzWarp:
    """Exact metal-fuzz gradients via the fuzz-sphere warp
    (diff/fuzz_warp.py). Offline truth on this scene (metal floor
    reflecting an emissive patch, rademacher-weighted luminance):
    plain-estimator CRN-FD = -522 +- 51 (K=768 pairs, eps=0.02);
    shipped-kernel AD measured -568 +- 120 at K=512
    (scratch/fuzz_param_sweep.log). The per-sample distribution is
    heavy-tailed (velocities scale like 1/fuzz^2), so the CI check uses
    a generous band around the pinned truth."""

    @staticmethod
    def _scene():
        from spectral_tpu.models.camera import make_camera
        from spectral_tpu.models.geometry import TriSoup
        from spectral_tpu.models.materials import MaterialBuilder
        from spectral_tpu.models.scenes import _scene_from

        mb = MaterialBuilder()
        metal = mb.metallic((0.9, 0.9, 0.9), 0.25)
        light = mb.emissive((1.0, 1.0, 1.0), 5.0)
        soup = TriSoup()
        soup.quad((-4.0, 0.0, -4.0), (8.0, 0.0, 0.0), (0.0, 0.0, 8.0), metal)
        soup.quad((0.5, 2.5, -0.5), (1.2, 0.0, 0.0), (0.0, 0.0, 1.2), light)
        scene = _scene_from(soup, mb.build(), (0.0, 0.0, 0.0))
        cam = make_camera(
            16, 16, vfov=60.0, lookfrom=(0.0, 1.2, -3.0), lookat=(0.5, 0.0, 0.0)
        )
        return scene, cam, metal

    @classmethod
    def _make_loss(cls, scene, cam, metal_row, warp):
        from spectral_tpu.diff.vertex_warp import edges_from_vertices

        edges = edges_from_vertices(scene.v0, scene.v1, scene.v2)
        px, py = _pixel_grid(16)
        W = jax.random.rademacher(jax.random.PRNGKey(42), (256,), jnp.float32)

        def loss(f, key):
            mats = dataclasses.replace(
                scene.materials, fuzz=scene.materials.fuzz.at[metal_row].set(f)
            )
            s = dataclasses.replace(scene, materials=mats)
            xyz = render_tile_xyz(
                s, cam, px, py, key, 4, 2, fuzz_warp=edges if warp else None
            )
            return jnp.sum(W * xyz[:, 1])

        return loss

    def test_primal_identity_and_plain_zero(self):
        scene, cam, metal_row = self._scene()
        f0 = jnp.float32(0.25)
        key = jax.random.PRNGKey(0)
        lp = self._make_loss(scene, cam, metal_row, warp=False)
        lw = self._make_loss(scene, cam, metal_row, warp=True)
        assert float(lp(f0, key)) == float(lw(f0, key))
        # contrast: the plain estimator's fuzz gradient is zero a.e.
        assert float(jax.grad(lp)(f0, key)) == 0.0

    def test_fuzz_gradient_matches_fd(self):
        scene, cam, metal_row = self._scene()
        f0 = jnp.float32(0.25)
        g = jax.jit(jax.grad(self._make_loss(scene, cam, metal_row, True)))
        K = 160
        ads = np.array([float(g(f0, jax.random.PRNGKey(i))) for i in range(K)])
        assert np.all(np.isfinite(ads))
        mean = ads.mean()
        sem = ads.std() / np.sqrt(K)
        truth = -522.0
        # nonvacuous sign + magnitude band (heavy tails: 3-sigma slack)
        assert mean < 0.0 and abs(mean) > 2.0 * sem, (mean, sem)
        assert 0.3 * abs(truth) - 3 * sem <= -mean <= 2.0 * abs(truth) + 3 * sem, (
            mean, sem,
        )
