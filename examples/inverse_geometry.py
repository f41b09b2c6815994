"""Recover an occluder's position from a target image (vertex gradients).

The north star's third gradient family: "pixel gradients w.r.t. ...
vertex positions are exact". Through the plain path-tracing estimator
they are zero almost everywhere — geometry only selects WHICH materials
a path multiplies (reference hit selection primitives/tri.cu:12-45), a
step function of the vertices. The warped-area estimator
(spectral_tpu/diff/vertex_warp.py) composes each sampled integration
variable (camera pixel, lambertian bounce direction) with an edge-built
warp whose determinant carries the silhouette boundary terms; ordinary
autodiff of the warped estimator is then unbiased for d(image)/d(vertex)
(validated against large-K common-random-number finite differences in
tests/test_diff.py::TestVertexWarp).

Scene: a lit floor, a small overhead area light, and a dark occluder
quad casting a soft shadow. The occluder is displaced +0.35 in x from
the target pose; SGD on the MSE pixel loss walks it back using ONLY
rendered-image gradients (both silhouette families act: the occluder's
direct silhouette and its shadow boundary on the floor).

Run (CPU, ~3 min):
  JAX_PLATFORMS=cpu python examples/inverse_geometry.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from spectral_tpu.diff import scene_with_vertices
from spectral_tpu.diff.vertex_warp import edges_from_vertices
from spectral_tpu.models.camera import make_camera
from spectral_tpu.models.geometry import TriSoup
from spectral_tpu.models.materials import MaterialBuilder
from spectral_tpu.models.scenes import _scene_from
from spectral_tpu.render.wavefront import render_tile_xyz

SIZE, SPP, BOUNCES = 16, 8, 3


def build() -> tuple:
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
        SIZE, SIZE, vfov=70.0, lookfrom=(0.0, 1.0, -3.0), lookat=(0.0, 0.0, 0.5)
    )
    return scene, cam


def main() -> None:
    scene, cam = build()
    v0, v1, v2 = scene.v0, scene.v1, scene.v2
    T = v0.shape[0]
    occ = (jnp.arange(T) >= 4)[:, None].astype(jnp.float32)  # occluder tris
    dir3 = jnp.array([1.0, 0.0, 0.0])
    px = jnp.arange(SIZE * SIZE, dtype=jnp.int32) % SIZE
    py = jnp.arange(SIZE * SIZE, dtype=jnp.int32) // SIZE

    def render(th, key, warp: bool):
        dv = th * dir3 * occ
        s = scene_with_vertices(scene, v0 + dv, v1 + dv, v2 + dv)
        vw = edges_from_vertices(v0 + dv, v1 + dv, v2 + dv) if warp else None
        xyz = render_tile_xyz(s, cam, px, py, key, SPP, BOUNCES, vertex_warp=vw)
        return xyz / SPP

    # MSE gradient with the two factors from INDEPENDENT keys (see
    # examples/inverse_dispersion.py: the warp preserves expectations,
    # not per-key joint moments; a shared key biases the product).
    # The residual is a common-random-numbers pair so its MC noise
    # cancels; the gradient factor is the warped vjp at a fresh key.
    @jax.jit
    def one_grad(th, k1, k2):
        ref = render(0.0, k1, False)  # target pose = 0
        cur = render(th, k1, False)
        resid = jax.lax.stop_gradient(cur - ref)

        _, vjp = jax.vjp(lambda t: render(t, k2, True), th)
        (g,) = vjp(2.0 * resid / resid.size)
        return jnp.mean(resid**2), g

    th = jnp.float32(0.35)  # initial displacement (x offset, world units)
    print(f"start   offset = {float(th):+.4f}")
    # calibrated (scratch/calib_ig.py): per-estimate g ~ +0.9 at th=0.35
    # with per-sample std ~0.85 (SNR ~1); M=4 averaging + lr=0.12 walks
    # 0.35 back in ~10 macro-steps, tail-clip at +-3 bounds MC spikes.
    lr, M = 0.12, 4
    key = jax.random.PRNGKey(3)
    for step in range(1, 41):
        gacc, L = 0.0, 0.0
        for _ in range(M):
            key, k1, k2 = jax.random.split(key, 3)
            Li, gi = one_grad(th, k1, k2)
            gacc += float(jnp.clip(gi, -3.0, 3.0))  # heavy-tail clip
            L = float(Li)
        th = th - lr * gacc / M
        if step % 10 == 0:
            print(f"step {step:3d}  loss {L:.3e}  offset = {float(th):+.4f}")

    print(f"final   offset = {float(th):+.4f}")
    assert abs(float(th)) < 0.5 * 0.35, "geometry recovery failed"
    print(f"recovered {100.0 * (1.0 - abs(float(th)) / 0.35):.1f}% of the displacement")


if __name__ == "__main__":
    main()
