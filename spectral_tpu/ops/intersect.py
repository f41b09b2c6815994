"""Ray-triangle intersection as batched matrix multiplies.

Data-parallel redesign of the reference's scalar hit pipeline (tri::hit,
primitives/tri.cu:3-45; bvh traversal bvh/bvh.cu:99-166). Instead of one
thread walking one ray through branchy plane/interior tests, we express the
whole test as affine functionals of the ray, evaluated for a [N_rays] x
[T_tris] block with five [N,3] @ [3,T] contractions:

  plane:    t(r, j)   = (D_j - n_j . o_r) / (n_j . d_r)       (tri.cu:12-25)
  interior: a_k(r, j) = (G_jk . o_r + c_jk) + t * (G_jk . d_r) (tri.cu:121-128)

where G/c are the per-edge affine functionals precomputed at scene build
(models/geometry.py finalize), with the winding sign folded in so the
interior test is uniformly ``a_k >= 0``. The nearest hit is a masked argmin
over the T axis. No per-ray control flow, no divergence.

This dense path serves reference-scale scenes (20-64 tris, at most
DENSE_CUTOFF). For large scenes ops/bvh.py culls to leaf clusters and
reuses the same tests on the gathered candidates.

Gradient policy (SURVEY section 7.5): the *selection* (argmin index, hit
mask) is discrete and detached; the selected hit's t, point and normal are
smooth functions of vertices/ray and carry gradients.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Ray-parallel-to-plane threshold (reference tri.cu:15)
DENOM_EPS = 1e-8
BIG = jnp.float32(3.4e38)


class HitRecord(NamedTuple):
    """SoA hit record (reference primitives/hit_record.cuh:13-45)."""

    t: jnp.ndarray  # [N] hit distance (BIG when miss)
    hit: jnp.ndarray  # [N] bool
    p: jnp.ndarray  # [N, 3] hit point
    normal: jnp.ndarray  # [N, 3] normal, flipped to face the ray
    front_face: jnp.ndarray  # [N] bool
    mat_index: jnp.ndarray  # [N] int32
    tri_index: jnp.ndarray  # [N] int32 (-1 when miss)


def intersect_block(
    o: jnp.ndarray,
    d: jnp.ndarray,
    v_normal: jnp.ndarray,
    v_d: jnp.ndarray,
    edge_g: jnp.ndarray,
    edge_c: jnp.ndarray,
    t_min: float | jnp.ndarray = 0.0,
    t_max: float | jnp.ndarray = BIG,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """All-pairs candidate test: rays [N] x tris [T] -> (t_all, valid).

    o, d: [N, 3]; v_normal: [T, 3]; v_d: [T]; edge_g: [T, 3, 3];
    edge_c: [T, 3]. Returns t_all [N, T] and valid [N, T] (plane hit within
    (t_min, t_max], interior, non-parallel).
    """
    f32 = jnp.float32
    o = o.astype(f32)
    d = d.astype(f32)
    # Five GEMMs, all [N, 3] @ [3, T(-ish)]: n.o, n.d, G.o (x3), G.d (x3)
    n_t = v_normal.T  # [3, T]
    no = o @ n_t
    nd = d @ n_t
    t_all = (v_d[None, :] - no) / nd  # [N, T]

    tcount = edge_g.shape[0]
    g_flat = edge_g.reshape(tcount * 3, 3).T  # [3, 3T]
    ao = (o @ g_flat).reshape(-1, tcount, 3) + edge_c[None]  # [N, T, 3]
    ad = (d @ g_flat).reshape(-1, tcount, 3)  # [N, T, 3]
    edge_vals = ao + t_all[..., None] * ad
    inside = jnp.all(edge_vals >= 0.0, axis=-1)  # [N, T]

    valid = (
        inside
        & (jnp.abs(nd) >= DENOM_EPS)
        & (t_all >= t_min)
        & (t_all <= t_max)
    )
    return t_all, valid


def nearest_hit(
    o: jnp.ndarray,
    d: jnp.ndarray,
    scene,
    t_min: float | jnp.ndarray = 0.0,
    t_max: float | jnp.ndarray = BIG,
) -> HitRecord:
    """Dense nearest-hit over the whole scene (brute force; the fast path
    for T <= O(128)). Equivalent to bvh::hit's nearest-tracking loop
    (bvh.cu:99-166) with traversal replaced by a masked argmin."""
    t_all, valid = intersect_block(
        o, d, scene.normal, scene.d, scene.edge_g, scene.edge_c, t_min, t_max
    )
    t_masked = jnp.where(valid, t_all, BIG)
    idx = jnp.argmin(t_masked, axis=-1).astype(jnp.int32)  # [N]
    hit = jnp.take_along_axis(valid, idx[:, None], axis=1)[:, 0]
    return _gather_record(o, d, scene, idx, hit)


def _gather_record(o, d, scene, idx, hit) -> HitRecord:
    """Build the hit record from a selected triangle index.

    Recomputes t from the gathered triangle so gradients flow through the
    *selected* plane equation only (selection itself is detached).
    """
    idx_sg = jax.lax.stop_gradient(idx)
    n_sel = scene.normal[idx_sg]  # [N, 3]
    d_sel = scene.d[idx_sg]  # [N]
    nd = jnp.sum(n_sel * d, axis=-1)
    no = jnp.sum(n_sel * o, axis=-1)
    t = (d_sel - no) / jnp.where(jnp.abs(nd) < DENOM_EPS, DENOM_EPS, nd)
    # p from the miss-zeroed t, NOT the BIG-masked one: BIG * d overflows
    # f32 to inf, and even though p is value-masked below, the backward of
    # this mul would scale p's cotangent by BIG (ct_d = t * ct_p) and the
    # inf trips 0*inf = NaN chains downstream (vertex-warp gradients).
    p = o + jnp.where(hit, t, 0.0)[:, None] * d
    t = jnp.where(hit, t, BIG)
    # set_face_normal (hit_record.cuh:30-45): flip toward the ray origin
    front = nd < 0.0
    normal = jnp.where(front[:, None], n_sel, -n_sel)
    return HitRecord(
        t=t,
        hit=hit,
        p=jnp.where(hit[:, None], p, 0.0),
        normal=normal,
        front_face=front,
        mat_index=scene.mat_index[idx_sg],
        tri_index=jnp.where(hit, idx_sg, -1),
    )


def ray_aabb(
    o: jnp.ndarray,
    inv_d: jnp.ndarray,
    bb_min: jnp.ndarray,
    bb_max: jnp.ndarray,
    t_min: float | jnp.ndarray = 0.0,
    t_max: float | jnp.ndarray = BIG,
) -> jnp.ndarray:
    """Slab test, rays [N] x boxes [B] -> bool [N, B].

    Matches aabb::hit (bvh/aabb.cu:7-40) including its strict
    ``max <= min -> miss`` comparison.
    """
    lo = (bb_min[None] - o[:, None]) * inv_d[:, None]  # [N, B, 3]
    hi = (bb_max[None] - o[:, None]) * inv_d[:, None]
    t0 = jnp.minimum(lo, hi)
    t1 = jnp.maximum(lo, hi)
    near = jnp.maximum(jnp.max(t0, axis=-1), t_min)
    far = jnp.minimum(jnp.min(t1, axis=-1), t_max)
    return near < far
