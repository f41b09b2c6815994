"""Karras-style LBVH: Morton-sort build in XLA + lockstep stack traversal.

The reference builds a pointer BVH with ONE CUDA thread doing iterative
median-splits with an in-kernel quicksort (bvh/bvh.cu:206-309) and traverses
it with a 64-deep local stack per thread (bvh.cu:99-166, after Karras's
"Thinking Parallel" articles, README.md:15). The data-parallel redesign:

* Build: 30-bit Morton codes over triangle-bbox centroids, one
  ``jax.lax.sort``, then Karras 2012's binary-radix-tree
  construction evaluated as a *closed-form vectorized op per internal node*
  (no sequential splitting at all). Leaves are CLUSTERS of ``leaf_size``
  consecutive Morton-ordered triangles, so a leaf visit is a dense
  [active_rays, leaf_size] block test.
  Internal bboxes are fitted with a bottom-up ready-flag sweep
  (`lax.while_loop`), replacing the reference's post-order stack pass
  (bvh.cu:311-346).

* Traversal: all rays advance in lockstep through a masked
  ``lax.while_loop`` with a per-ray [STACK_DEPTH] stack in device memory --
  the vectorized equivalent of the reference's per-thread stack walk, with
  nearest-hit tracking (t_best narrows as hits are found, like bvh.cu's
  closest-so-far max).

For reference-scale scenes (<= ~128 tris after padding) the dense
``ops.intersect.nearest_hit`` path is faster than any traversal; the LBVH
exists for the large-scene capability and kicks in automatically above
``DENSE_CUTOFF`` (models/scenes.py::auto_bvh).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .intersect import BIG, _gather_record, intersect_block

STACK_DEPTH = 64  # matches the reference's MAX_DEPTH (bvh.cuh:12)
SLAB_FAR_SCALE = 1.0 + 2.0 * (3 * 2.0**-24) / (1 - 3 * 2.0**-24)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LBVH:
    """Flat-array BVH over leaf clusters.

    n_leaves = L, internal nodes = L - 1 (Karras). Node ids: internal nodes
    are [0, L-1), leaf k is encoded as id (L - 1 + k). A registered pytree
    with static ``leaf_size``/``n_tris`` so it passes through jit/shard_map
    inside a Scene.
    """

    node_min: jnp.ndarray  # [2L-1, 3] bbox min per node (internal + leaf)
    node_max: jnp.ndarray  # [2L-1, 3]
    left: jnp.ndarray  # [L-1] child id
    right: jnp.ndarray  # [L-1] child id
    leaf_start: jnp.ndarray  # [L] first tri (in sorted order) of each leaf
    order: jnp.ndarray  # [T_padded] sorted tri indices (pad = last tri)
    leaf_size: int = dataclasses.field(metadata={"static": True}, default=8)
    n_tris: int = dataclasses.field(metadata={"static": True}, default=0)


def _expand_bits(x: jnp.ndarray) -> jnp.ndarray:
    """Spread 10 bits to every 3rd position (standard Morton interleave)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(centroids: jnp.ndarray, lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    """30-bit Morton codes for points normalized into the scene bounds."""
    q = jnp.clip((centroids - lo) / jnp.maximum(hi - lo, 1e-12), 0.0, 0.99999)
    xyz = (q * 1024.0).astype(jnp.uint32)
    ex = _expand_bits(xyz[:, 0])
    ey = _expand_bits(xyz[:, 1])
    ez = _expand_bits(xyz[:, 2])
    return (ex << 2) | (ey << 1) | ez


def _clz32(x: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.clz(x.astype(jnp.int32))


def _delta(codes: jnp.ndarray, i: jnp.ndarray, j: jnp.ndarray) -> jnp.ndarray:
    """Longest-common-prefix length between sorted codes i and j; -1 when j
    is out of range (Karras 2012 section 4). Codes are pre-uniquified by
    appending the index bits, so delta is always well defined in range."""
    n = codes.shape[0]
    valid = (j >= 0) & (j < n)
    jc = jnp.clip(j, 0, n - 1)
    x = codes[i] ^ codes[jc]
    return jnp.where(valid, _clz32(x), -1)


def build_lbvh(bbox_min: jnp.ndarray, bbox_max: jnp.ndarray, leaf_size: int = 8) -> LBVH:
    """Build the LBVH over T triangles given their AABBs.

    Fully vectorized: sort + per-node closed-form range/split computation.
    T is padded to a multiple of leaf_size by repeating the last triangle.
    """
    # the tree is a discrete acceleration structure: no gradient flows
    # through it (reverse-mode AD cannot pass the bottom-up while_loop)
    bbox_min = jax.lax.stop_gradient(bbox_min)
    bbox_max = jax.lax.stop_gradient(bbox_max)
    t = bbox_min.shape[0]
    centroids = 0.5 * (bbox_min + bbox_max)
    lo = jnp.min(bbox_min, axis=0)
    hi = jnp.max(bbox_max, axis=0)
    codes = morton_codes(centroids, lo, hi)

    # sort tris by morton code
    order = jnp.argsort(codes).astype(jnp.int32)
    sorted_codes = codes[order]

    # pad to a leaf_size multiple with copies of the last sorted tri
    t_pad = -(-t // leaf_size) * leaf_size
    pad = t_pad - t
    order_p = jnp.concatenate([order, jnp.repeat(order[-1:], pad, 0)])
    codes_p = jnp.concatenate([sorted_codes, jnp.repeat(sorted_codes[-1:], pad, 0)])

    n_leaves = t_pad // leaf_size
    leaf_start = jnp.arange(n_leaves, dtype=jnp.int32) * leaf_size

    # leaf keys: morton code of the first tri in each cluster, uniquified by
    # appending the leaf index in the low bits (keeps delta() total)
    leaf_codes = codes_p[leaf_start]
    # shift into high bits of int64? stay in 32-bit: delta over (code, idx)
    # pairs emulated by comparing codes first, indices on ties.
    idxs = jnp.arange(n_leaves, dtype=jnp.uint32)

    def delta(i, j):
        n = n_leaves
        valid = (j >= 0) & (j < n)
        jc = jnp.clip(j, 0, n - 1)
        x = leaf_codes[i] ^ leaf_codes[jc]
        # tie-break equal codes with index bits (Karras section 4 note)
        tie = idxs[i] ^ idxs[jc]
        lcp = jnp.where(x == 0, 32 + _clz32(tie), _clz32(x))
        return jnp.where(valid, lcp, -1)

    if n_leaves == 1:
        # degenerate single-leaf tree
        return LBVH(
            node_min=jnp.concatenate([lo[None], lo[None]]),
            node_max=jnp.concatenate([hi[None], hi[None]]),
            left=jnp.zeros((1,), jnp.int32),
            right=jnp.zeros((1,), jnp.int32),
            leaf_start=leaf_start,
            leaf_size=leaf_size,
            order=order_p,
            n_tris=t,
        )

    i = jnp.arange(n_leaves - 1, dtype=jnp.int32)

    # --- Karras: determine range direction and extent per internal node ---
    d = jnp.sign(delta(i, i + 1) - delta(i, i - 1)).astype(jnp.int32)
    d = jnp.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    n_search = int(np.ceil(np.log2(max(n_leaves, 2)))) + 2

    # upper bound for range length by doubling (Karras 2012, section 4)
    lmax = jnp.ones_like(i) * 2
    for _ in range(n_search):
        lmax = jnp.where(delta(i, i + lmax * d) > delta_min, lmax * 2, lmax)

    # binary search the exact other end of the range; extra iterations at
    # step 1 are provably no-ops, so a static bound is safe
    l = jnp.zeros_like(i)
    step = lmax
    for _ in range(n_search + 2):
        step = (step + 1) >> 1
        cond = delta(i, i + (l + step) * d) > delta_min
        l = jnp.where(cond, l + step, l)
    j = i + l * d

    # split position: binary search for the highest differing-bit boundary
    delta_node = delta(i, j)
    s = jnp.zeros_like(i)
    step = l
    for _ in range(n_search + 2):
        step = (step + 1) >> 1
        cond = delta(i, i + (s + step) * d) > delta_node
        s = jnp.where(cond, s + step, s)
    gamma = i + s * d + jnp.minimum(d, 0)

    rng_lo = jnp.minimum(i, j)
    rng_hi = jnp.maximum(i, j)
    # child ids: internal node k in [0, L-1), leaf k encoded as L-1+k
    left = jnp.where(rng_lo == gamma, (n_leaves - 1) + gamma, gamma).astype(jnp.int32)
    right = jnp.where(rng_hi == gamma + 1, (n_leaves - 1) + gamma + 1, gamma + 1).astype(jnp.int32)

    # --- leaf bboxes ---
    bmin_p = bbox_min[order_p].reshape(n_leaves, leaf_size, 3)
    bmax_p = bbox_max[order_p].reshape(n_leaves, leaf_size, 3)
    leaf_min = bmin_p.min(axis=1)
    leaf_max = bmax_p.max(axis=1)

    # --- bottom-up bbox fit with ready flags ---
    n_int = n_leaves - 1
    node_min = jnp.concatenate([jnp.full((n_int, 3), jnp.inf, jnp.float32), leaf_min])
    node_max = jnp.concatenate([jnp.full((n_int, 3), -jnp.inf, jnp.float32), leaf_max])
    ready = jnp.concatenate([jnp.zeros(n_int, bool), jnp.ones(n_leaves, bool)])

    def fit_cond(state):
        _, _, ready = state
        return ~jnp.all(ready[:n_int])

    def fit_body(state):
        nmin, nmax, ready = state
        can = ready[left] & ready[right] & ~ready[:n_int]
        new_min = jnp.minimum(nmin[left], nmin[right])
        new_max = jnp.maximum(nmax[left], nmax[right])
        nmin = nmin.at[:n_int].set(jnp.where(can[:, None], new_min, nmin[:n_int]))
        nmax = nmax.at[:n_int].set(jnp.where(can[:, None], new_max, nmax[:n_int]))
        ready = ready.at[:n_int].set(ready[:n_int] | can)
        return nmin, nmax, ready

    node_min, node_max, _ = jax.lax.while_loop(fit_cond, fit_body, (node_min, node_max, ready))

    return LBVH(
        node_min=node_min,
        node_max=node_max,
        left=left,
        right=right,
        leaf_start=leaf_start,
        leaf_size=leaf_size,
        order=order_p,
        n_tris=t,
    )


def nearest_hit_bvh(o: jnp.ndarray, d: jnp.ndarray, scene, bvh: LBVH):
    """Lockstep stack traversal + dense leaf-cluster tests.

    Vectorized equivalent of bvh::hit (reference bvh.cu:99-166): every ray
    keeps a [STACK_DEPTH] node stack; each while-loop step pops one node per
    ray, AABB-tests it against the narrowing [0, t_best] interval, and either
    pushes children or runs the block intersector on the leaf's
    ``leaf_size`` triangles.

    The walk only selects the hit triangle, so it runs on
    gradient-stopped rays and geometry; the returned record is recomputed
    differentiably from the selected index (``_gather_record``), which is
    the same policy as the dense path's detached argmin.
    """
    o_full, d_full = o, d
    o, d = jax.lax.stop_gradient(o), jax.lax.stop_gradient(d)
    tri_normal, tri_d, tri_eg, tri_ec = jax.lax.stop_gradient(
        (scene.normal, scene.d, scene.edge_g, scene.edge_c)
    )
    n = o.shape[0]
    n_leaves = bvh.leaf_start.shape[0]
    n_int = n_leaves - 1
    inv_d = 1.0 / d

    ls = bvh.leaf_size
    sorted_tri = bvh.order  # [T_pad]

    # gather per-leaf tri data once: [L, ls] indices
    leaf_tris = sorted_tri.reshape(n_leaves, ls)

    if n_int == 0:
        # single leaf: dense test of everything
        tri_idx = leaf_tris[0]
        t_all, valid = intersect_block(
            o, d, tri_normal[tri_idx], tri_d[tri_idx], tri_eg[tri_idx], tri_ec[tri_idx]
        )
        t_masked = jnp.where(valid, t_all, BIG)
        j = jnp.argmin(t_masked, axis=-1)
        hit = jnp.take_along_axis(valid, j[:, None], 1)[:, 0]
        idx = tri_idx[j]
        return _gather_record(o_full, d_full, scene, idx.astype(jnp.int32), hit)

    def aabb_one(node_id, t_best):
        """AABB slab test of one node id per ray against [0, t_best]."""
        bmin = bvh.node_min[node_id]  # [N, 3]
        bmax = bvh.node_max[node_id]
        lo = (bmin - o) * inv_d
        hi = (bmax - o) * inv_d
        t0 = jnp.minimum(lo, hi)
        t1 = jnp.maximum(lo, hi)
        near = jnp.maximum(jnp.max(t0, axis=-1), 0.0)
        # conservative exit (Ize 2013, robust BVH traversal): scale the far
        # distance by 1 + 2*gamma(3) and accept touching slabs, so planar
        # leaves (axis-aligned walls, whose AABBs are one ulp thick) are
        # never culled by rounding; the leaf test decides the hit
        far = jnp.minimum(jnp.min(t1, axis=-1) * SLAB_FAR_SCALE, t_best)
        return near <= far

    # state: stack [N, S], sp [N], t_best [N], best_idx [N], best_valid [N]
    stack = jnp.zeros((n, STACK_DEPTH), jnp.int32)
    sp = jnp.ones((n,), jnp.int32)  # root (node 0) pushed
    t_best = jnp.full((n,), BIG)
    best_idx = jnp.zeros((n,), jnp.int32)
    best_valid = jnp.zeros((n,), bool)

    def cond(state):
        _, sp, *_ = state
        return jnp.any(sp > 0)

    def body(state):
        stack, sp, t_best, best_idx, best_valid = state
        active = sp > 0
        sp_pop = jnp.where(active, sp - 1, sp)
        node = stack[jnp.arange(n), jnp.clip(sp_pop, 0, STACK_DEPTH - 1)]
        node = jnp.where(active, node, 0)

        hit_box = aabb_one(node, t_best) & active
        is_leaf = node >= n_int

        # --- leaf path: dense cluster test (only meaningful where leaf) ---
        leaf_id = jnp.clip(node - n_int, 0, n_leaves - 1)
        tri_idx = leaf_tris[leaf_id]  # [N, ls]
        # gather per-ray candidate tri data
        vn = tri_normal[tri_idx]  # [N, ls, 3]
        vd = tri_d[tri_idx]  # [N, ls]
        eg = tri_eg[tri_idx]  # [N, ls, 3, 3]
        ec = tri_ec[tri_idx]  # [N, ls, 3]
        no = jnp.einsum("nc,nlc->nl", o, vn)
        nd = jnp.einsum("nc,nlc->nl", d, vn)
        t_all = (vd - no) / nd
        ao = jnp.einsum("nc,nlkc->nlk", o, eg) + ec
        ad = jnp.einsum("nc,nlkc->nlk", d, eg)
        inside = jnp.all(ao + t_all[..., None] * ad >= 0.0, axis=-1)
        valid = (
            inside
            & (jnp.abs(nd) >= 1e-8)
            & (t_all >= 0.0)
            & (t_all <= t_best[:, None])
            & (hit_box & is_leaf)[:, None]
        )
        t_masked = jnp.where(valid, t_all, BIG)
        jbest = jnp.argmin(t_masked, axis=-1)
        t_leaf = jnp.take_along_axis(t_masked, jbest[:, None], 1)[:, 0]
        v_leaf = jnp.take_along_axis(valid, jbest[:, None], 1)[:, 0]
        improved = v_leaf & (t_leaf < t_best)
        t_best = jnp.where(improved, t_leaf, t_best)
        best_idx = jnp.where(improved, jnp.take_along_axis(tri_idx, jbest[:, None], 1)[:, 0], best_idx)
        best_valid = best_valid | improved

        # --- internal path: push children ---
        push = hit_box & ~is_leaf
        node_c = jnp.clip(node, 0, n_int - 1)
        lch = bvh.left[node_c]
        rch = bvh.right[node_c]
        ar = jnp.arange(n)
        # push left then right (right popped first), masked
        stack = stack.at[ar, jnp.clip(sp_pop, 0, STACK_DEPTH - 1)].set(
            jnp.where(push, lch, stack[ar, jnp.clip(sp_pop, 0, STACK_DEPTH - 1)])
        )
        sp1 = jnp.where(push, sp_pop + 1, sp_pop)
        stack = stack.at[ar, jnp.clip(sp1, 0, STACK_DEPTH - 1)].set(
            jnp.where(push, rch, stack[ar, jnp.clip(sp1, 0, STACK_DEPTH - 1)])
        )
        sp2 = jnp.where(push, sp1 + 1, sp1)
        return stack, sp2, t_best, best_idx, best_valid

    state = (stack, sp, t_best, best_idx, best_valid)
    _, _, t_best, best_idx, best_valid = jax.lax.while_loop(cond, body, state)
    return _gather_record(o_full, d_full, scene, best_idx, best_valid)
