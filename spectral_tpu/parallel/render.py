"""Mesh-sharded rendering + inverse-rendering train step.

This is the multi-device replacement for the reference's sequential chunk loop
(reference rendering/render_manager.cu:3-66 ``step`` + the producer/consumer
double buffer render_manager.cuh:68-181): the image's row blocks become
shards on the ``tile`` mesh axis and the spp axis is sharded over ``sample``,
with one ``psum`` on the sample axis to merge partial Monte Carlo sums.

Everything is expressed with ``jax.shard_map`` over a 2D Mesh, so XLA
hands the collectives to NCCL on GPUs; the same code runs on a virtual CPU
mesh in tests (SURVEY.md section 4 item 4).

Gradients: ``render_image_sharded`` is differentiable; the shard_map
transpose turns the forward psum into the gradient all-reduce, which is
exactly the "scene-parameter gradients psum-reduced across devices"
design from the BASELINE north star.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..models.camera import Camera
from ..models.materials import tabulate
from ..ops.pallas.render_kernel import (
    BLOCK,
    camera_vector,
    pack_scene,
    render_rays_pallas,
)
from ..render.wavefront import render_tile_xyz
from ..utils.constants import DENSE_CUTOFF
from ..utils.prng import fold
from .mesh import SAMPLE_AXIS, TILE_AXIS


def render_image_sharded(
    scene,
    cam: Camera,
    key: jax.Array,
    mesh,
    samples_per_pixel: int,
    bounce_limit: int,
    vertex_warp=None,
    fuzz_warp=None,
) -> jnp.ndarray:
    """Full-image accumulated XYZ [H, W, 3], sharded (tile x sample).

    Each (tile, sample) shard renders H/n_tile rows at spp/n_sample samples;
    row blocks concatenate over ``tile``, partial sums psum over ``sample``.
    H and spp must divide by the respective mesh extents.
    ``vertex_warp``: optional EdgeSet (diff/vertex_warp.py), replicated to
    every shard, enabling exact vertex-position gradients.
    """
    h, w = cam.image_height, cam.image_width
    n_tile = mesh.shape[TILE_AXIS]
    n_samp = mesh.shape[SAMPLE_AXIS]
    if h % n_tile or samples_per_pixel % n_samp:
        raise ValueError(
            f"height {h} / spp {samples_per_pixel} must divide mesh "
            f"({n_tile} x {n_samp})"
        )
    rows = h // n_tile
    local_spp = samples_per_pixel // n_samp

    def shard_fn(scene, cam, key, vertex_warp, fuzz_warp):
        ti = jax.lax.axis_index(TILE_AXIS)
        si = jax.lax.axis_index(SAMPLE_AXIS)
        y0 = ti * rows
        ys, xs = jnp.meshgrid(
            jnp.arange(rows, dtype=jnp.int32),
            jnp.arange(w, dtype=jnp.int32),
            indexing="ij",
        )
        # fold both mesh coordinates so every shard draws unique samples
        k = fold(key, ti, si)
        xyz = render_tile_xyz(
            scene, cam, xs.ravel(), (ys + y0).ravel(), k, local_spp,
            bounce_limit, vertex_warp=vertex_warp, fuzz_warp=fuzz_warp,
        )
        xyz = jax.lax.psum(xyz, SAMPLE_AXIS)
        return xyz.reshape(rows, w, 3)

    # check_vma=False: the bounce-scan carry mixes axis-varying ray data with
    # invariant init constants, which the varying-manual-axes checker rejects;
    # all communication here is the one explicit psum above.
    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=P(TILE_AXIS, None, None),
        check_vma=False,
    )
    return fn(scene, cam, key, vertex_warp, fuzz_warp)


def render_image_sharded_pallas(
    scene,
    cam: Camera,
    seed: int,
    mesh,
    samples_per_pixel: int,
    bounce_limit: int,
    block: int = BLOCK,
    interpret: bool = False,
) -> jnp.ndarray:
    """Full-image accumulated XYZ [H, W, 3] with the megakernel
    (ops/pallas/render_kernel.py) on every (tile, sample) shard.

    Same decomposition as ``render_image_sharded``: row blocks ride
    ``tile``, spp shards ride ``sample`` with one psum. Each shard hashes
    its own seed, so every shard draws its own samples. Dense scenes only,
    like the kernel itself.
    """
    if scene.num_tris > DENSE_CUTOFF:
        raise ValueError(
            f"{scene.num_tris} triangles > DENSE_CUTOFF={DENSE_CUTOFF}: "
            "use render_image_sharded (XLA LBVH path)"
        )
    h, w = cam.image_height, cam.image_width
    n_tile = mesh.shape[TILE_AXIS]
    n_samp = mesh.shape[SAMPLE_AXIS]
    if h % n_tile or samples_per_pixel % n_samp:
        raise ValueError(
            f"height {h} / spp {samples_per_pixel} must divide mesh "
            f"({n_tile} x {n_samp})"
        )
    rows = h // n_tile
    local_spp = samples_per_pixel // n_samp
    n_local = rows * w
    pad = (-n_local) % block
    packed = (camera_vector(cam),) + pack_scene(scene)

    def shard_fn(cam_vec, tri_pack, mat_pack, tables):
        ti = jax.lax.axis_index(TILE_AXIS)
        si = jax.lax.axis_index(SAMPLE_AXIS)
        ys, xs = jnp.meshgrid(
            jnp.arange(rows, dtype=jnp.int32) + ti * rows,
            jnp.arange(w, dtype=jnp.int32),
            indexing="ij",
        )
        px = jnp.pad(xs.ravel(), (0, pad)).astype(jnp.float32)
        py = jnp.pad(ys.ravel(), (0, pad)).astype(jnp.float32)
        shard_seed = (seed + (ti * n_samp + si) * 7919999) & 0x7FFFFFFF
        xyz = render_rays_pallas(
            cam_vec, shard_seed, tri_pack, mat_pack, tables, px, py,
            local_spp, bounce_limit, block, interpret,
        )
        xyz = jax.lax.psum(xyz[:n_local], SAMPLE_AXIS)
        return xyz.reshape(rows, w, 3)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(),) * len(packed),
        out_specs=P(TILE_AXIS, None, None),
        check_vma=False,
    )
    return fn(*packed)


# ---------------------------------------------------------------------------
# Inverse rendering (new capability — the reference is forward-only,
# SURVEY.md "no autodiff anywhere")
# ---------------------------------------------------------------------------


_VERTEX_KEYS = ("v0", "v1", "v2")


def trainable_params(scene, include_vertices: bool = False) -> dict:
    """The differentiable scene leaves recovered by inverse rendering:
    material sigmoid-spectrum coefficients, emission powers, metal fuzz,
    Sellmeier dispersion coefficients (BASELINE config 5), and — with
    ``include_vertices`` — the triangle vertex positions (exact gradients
    via the warped-area estimator, diff/vertex_warp.py)."""
    m = scene.materials
    p = {
        "coeffs": m.coeffs,
        "emission_power": m.emission_power,
        "fuzz": m.fuzz,
        "sellmeier_b": m.sellmeier_b,
        "sellmeier_c": m.sellmeier_c,
    }
    if include_vertices:
        p.update({k: getattr(scene, k) for k in _VERTEX_KEYS})
    return p


def apply_params(scene, params: dict):
    """Rebuild the scene with updated leaves. Material leaves re-tabulate
    SPDs; vertex leaves re-derive the intersection arrays differentiably
    (diff/geometry.py::scene_with_vertices)."""
    mat_params = {k: v for k, v in params.items() if k not in _VERTEX_KEYS}
    mats = dataclasses.replace(scene.materials, **mat_params)
    scene = dataclasses.replace(scene, materials=tabulate(mats))
    if "v0" in params:
        from ..diff.geometry import scene_with_vertices

        scene = scene_with_vertices(
            scene, params["v0"], params["v1"], params["v2"]
        )
    return scene


def image_loss(
    params: dict,
    scene,
    cam: Camera,
    target_xyz: jnp.ndarray,
    key: jax.Array,
    mesh,
    samples_per_pixel: int,
    bounce_limit: int,
    vertex_warp: bool = False,
    fuzz_warp: bool = False,
) -> jnp.ndarray:
    """Mean squared error between the sharded render of the scene under
    ``params`` and ``target_xyz`` [H, W, 3] (mean-per-sample XYZ): the
    objective ``train_step`` descends. With a fixed ``key`` it is a
    deterministic function of ``params`` (common random numbers), which is
    what a finite-difference check needs."""
    s = apply_params(scene, params)
    vw = None
    fz = None
    if vertex_warp and "v0" in params:
        from ..diff.vertex_warp import edges_from_vertices

        vw = edges_from_vertices(params["v0"], params["v1"], params["v2"])
    if fuzz_warp:
        from ..diff.vertex_warp import edges_from_vertices

        fz = edges_from_vertices(s.v0, s.v1, s.v2)
    xyz = render_image_sharded(
        s, cam, key, mesh, samples_per_pixel, bounce_limit,
        vertex_warp=vw, fuzz_warp=fz,
    )
    img = xyz / float(samples_per_pixel)
    return jnp.mean((img - target_xyz) ** 2)


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "samples_per_pixel", "bounce_limit", "lr", "vertex_warp",
        "fuzz_warp",
    ),
)
def train_step(
    params: dict,
    scene,
    cam: Camera,
    target_xyz: jnp.ndarray,
    key: jax.Array,
    mesh,
    samples_per_pixel: int,
    bounce_limit: int,
    lr: float = 1e-2,
    vertex_warp: bool = False,
    fuzz_warp: bool = False,
):
    """One SGD step of inverse rendering on the device mesh.

    Renders the scene under ``params``, L2-compares against ``target_xyz``
    [H, W, 3] (mean-per-sample XYZ; ``image_loss``), and descends the
    material/dispersion parameters. The gradient all-reduce is the
    transpose of the forward sample-axis psum. With ``vertex_warp`` (and
    vertex leaves in ``params``), the warped-area estimator makes the
    vertex gradients exact (silhouette boundary terms included).
    """
    loss, grads = jax.value_and_grad(image_loss)(
        params, scene, cam, target_xyz, key, mesh, samples_per_pixel,
        bounce_limit, vertex_warp, fuzz_warp,
    )
    new_params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    return new_params, loss
