"""Pallas (Triton) megakernel: the whole spectral path trace of a ray block.

The fast forward path for dense scenes on a GPU. It keeps the shape of the
reference's own kernel (spectral_render_kernel, rendering/rendering.cu:
151-235): a ray owns its pixel through every sample and bounce, and path
state never leaves registers. One program owns ``block`` rays (one per
thread at ``num_warps * 32 == block``) and loops over samples, bounces and
triangles inside the kernel; only the accumulated XYZ is written back.

Layout:
- per-ray state is a ``[block]`` vector; wavelength-indexed state is
  ``[block, WP]`` with the hero wavelength in column 0;
- the triangle sweep is a ``fori_loop`` over the packed triangle table
  with scalar loads (the table is a few KB and stays in L1);
- material rows and the CIE / D65 / background curves are read by
  vector-index gathers from small flat global arrays;
- random numbers come from a counter-based integer hash of (seed, pixel,
  sample, draw), or from an injected uniform array ``rand [spp,
  n_uniforms(bounces), N]`` that pins the kernel to golden images.

All arithmetic is plain fp32; the contractions are 3 wide, so there is no
work for the tensor cores. The XLA wavefront (render/wavefront.py) stays
the differentiable reference; tests/test_pallas.py holds the two together.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ...utils.constants import (
    DENSE_CUTOFF,
    EPSILON,
    LAMBDA_MAX,
    LAMBDA_MIN,
    N_CIE_SAMPLES,
    N_RAY_WAVELENGTHS,
    cie_d65_normalized,
    cie_x,
    cie_y,
    cie_z,
)

BIG = 3.4e38
DENOM_EPS = 1e-8
W = N_RAY_WAVELENGTHS  # wavelengths per ray, hero at index 0
# Triton tensors have power-of-two extents: wavelength state is [block, WP]
# with the columns past W carried along and never integrated
WP = 8
assert W <= WP

# rays per program: one ray per thread, block // 32 warps
BLOCK = 128

# tri constant pack [T, 17]: normal(0:3), d(3), edge_g(4:13), edge_c(13:16),
# mat_index(16, as float)
TRI_PACK_WIDTH = 17
# material row pack [M, 16]: coeffs(0:3), is_lamb(3), is_metal(4), is_diel(5),
# is_emis(6), fuzz(7), power_sq(8), sellmeier_b(9:12), sellmeier_c(12:15)
MAT_PACK_WIDTH = 16
# curve table rows, N_CIE_SAMPLES each
TAB_CIE_X, TAB_CIE_Y, TAB_CIE_Z, TAB_D65, TAB_BG = range(5)


def pack_scene(scene) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Flat (tri_pack [T*17], mat_pack [M*16], tables [5*95]) f32 arrays."""
    from ...models.materials import DIELECTRIC, EMISSIVE, METALLIC

    tri = jnp.concatenate(
        [
            scene.normal,
            scene.d[:, None],
            scene.edge_g.reshape(-1, 9),
            scene.edge_c,
            scene.mat_index[:, None].astype(jnp.float32),
        ],
        axis=1,
    ).astype(jnp.float32)

    m = scene.materials
    t = m.mat_type
    is_metal = (t == METALLIC).astype(jnp.float32)
    is_diel = (t == DIELECTRIC).astype(jnp.float32)
    is_emis = (t == EMISSIVE).astype(jnp.float32)
    is_lamb = jnp.clip(1.0 - is_metal - is_diel - is_emis, 0.0, 1.0)
    mat = jnp.concatenate(
        [
            m.coeffs,
            is_lamb[:, None],
            is_metal[:, None],
            is_diel[:, None],
            is_emis[:, None],
            m.fuzz[:, None],
            (m.emission_power**2)[:, None],
            m.sellmeier_b,
            m.sellmeier_c,
            jnp.zeros((t.shape[0], 1), jnp.float32),
        ],
        axis=1,
    ).astype(jnp.float32)

    tab = jnp.stack(
        [
            jnp.asarray(cie_x, jnp.float32),
            jnp.asarray(cie_y, jnp.float32),
            jnp.asarray(cie_z, jnp.float32),
            jnp.asarray(cie_d65_normalized, jnp.float32),
            scene.background_spd.astype(jnp.float32),
        ]
    )
    return tri.reshape(-1), mat.reshape(-1), tab.reshape(-1)


def camera_vector(cam) -> jnp.ndarray:
    """Pack the camera frame into [20] scalars (center, pixel00, delta_u,
    delta_v, defocus_u, defocus_v, defocus flag, pad)."""
    has_defocus = 1.0 if float(cam.defocus_angle) > 0.0 else 0.0
    return jnp.concatenate(
        [
            cam.center,
            cam.pixel00_loc,
            cam.pixel_delta_u,
            cam.pixel_delta_v,
            cam.defocus_disk_u,
            cam.defocus_disk_v,
            jnp.asarray([has_defocus, 0.0], jnp.float32),
        ]
    ).astype(jnp.float32)


def n_uniforms(bounces: int) -> int:
    """Uniform draws per sample: jitter(2) + hero(1) + 3 per bounce +
    defocus disk(2, at the tail)."""
    return 5 + 3 * bounces


def _hash32(x):
    """splitmix-style integer finalizer on uint32 (wraparound)."""
    x = x.astype(jnp.uint32)
    x = (x ^ (x >> 16)) * jnp.uint32(0x7FEB352D)
    x = (x ^ (x >> 15)) * jnp.uint32(0x846CA68B)
    return x ^ (x >> 16)


def _bits_to_uniform(bits):
    """U[0,1) from the top 24 bits."""
    return (bits >> 8).astype(jnp.int32).astype(jnp.float32) * (1.0 / 16777216.0)


def _lerp_table(tab_ref, row: int, lam):
    """Linear interpolation of a 95-sample curve at wavelengths ``lam``
    (spectrum_interp, spectrum/spectrum.cu:11-22)."""
    xg = (lam - LAMBDA_MIN) * ((N_CIE_SAMPLES - 1) / (LAMBDA_MAX - LAMBDA_MIN))
    cell = jnp.clip(xg.astype(jnp.int32), 0, N_CIE_SAMPLES - 2)
    frac = xg - cell.astype(jnp.float32)
    idx = cell + row * N_CIE_SAMPLES
    return (1.0 - frac) * tab_ref[idx] + frac * tab_ref[idx + 1]


def _scatter_shade(
    ox, oy, oz, dx, dy, dz, power, alive, n_valid,
    best_t, best_hit, best_front, best_nx, best_ny, best_nz, best_mat,
    mat_ref, hero, lam, d65, bg, u_a, u_b, u_c,
):
    """Material fetch + spectral weight + scatter + termination for one
    bounce, with the semantics of ops/shading.py::scatter_step. Masks are
    f32 0/1. ``power``, ``lam``, ``d65``, ``bg`` are [block, WP]; the rest
    are [block]. ``u_a/u_b/u_c`` are the bounce's three uniform draws
    (sphere z, sphere phi, reflectance test)."""
    hit = best_hit * alive
    miss = (1.0 - best_hit) * alive
    t_safe = jnp.where(best_hit > 0.0, best_t, 0.0)
    hx = ox + t_safe * dx
    hy = oy + t_safe * dy
    hz = oz + t_safe * dz

    row = best_mat * MAT_PACK_WIDTH
    c0, c1, c2 = mat_ref[row], mat_ref[row + 1], mat_ref[row + 2]
    is_lamb, is_metal = mat_ref[row + 3], mat_ref[row + 4]
    is_diel, is_emis = mat_ref[row + 5], mat_ref[row + 6]
    fuzz, power_sq = mat_ref[row + 7], mat_ref[row + 8]
    b0, b1, b2 = mat_ref[row + 9], mat_ref[row + 10], mat_ref[row + 11]
    sc0, sc1, sc2 = mat_ref[row + 12], mat_ref[row + 13], mat_ref[row + 14]

    # spectral weight per wavelength (tabulate semantics, material.cuh:
    # 71-84 + ray::mul_spectrum); the sigmoid-poly SPD is evaluated
    # directly at lambda
    x = (c0[:, None] * lam + c1[:, None]) * lam + c2[:, None]
    sig = 0.5 * x / jnp.sqrt(1.0 + x * x) + 0.5
    spd = (
        is_diel[:, None]
        + (is_emis * power_sq)[:, None] * sig * d65
        + (is_lamb + is_metal)[:, None] * sig
    )
    weight = hit[:, None] * spd + miss[:, None] * bg + (1.0 - alive)[:, None]
    new_power = power * weight

    # scatter directions
    ilen = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz)
    ux, uy, uz = dx * ilen, dy * ilen, dz * ilen
    # uniform unit sphere in closed form (distribution of the reference's
    # rejection loop, vec3.cuh:209-246)
    sz = 2.0 * u_a - 1.0
    sphi = (2.0 * 3.14159265358979) * u_b
    sr = jnp.sqrt(jnp.maximum(1.0 - sz * sz, 0.0))
    sx = sr * jnp.cos(sphi)
    sy = sr * jnp.sin(sphi)

    # lambertian (material.cu:8-19); degenerate -> normal
    lx = best_nx + sx
    ly = best_ny + sy
    lz = best_nz + sz
    degen = (jnp.abs(lx) < 1e-8) & (jnp.abs(ly) < 1e-8) & (jnp.abs(lz) < 1e-8)
    lx = jnp.where(degen, best_nx, lx)
    ly = jnp.where(degen, best_ny, ly)
    lz = jnp.where(degen, best_nz, lz)

    # metallic (material.cu:22-37)
    dn = ux * best_nx + uy * best_ny + uz * best_nz
    rx = ux - 2.0 * dn * best_nx
    ry = uy - 2.0 * dn * best_ny
    rz = uz - 2.0 * dn * best_nz
    mx = rx + fuzz * sx
    my = ry + fuzz * sy
    mz = rz + fuzz * sz
    metal_ok = jnp.where((mx * best_nx + my * best_ny + mz * best_nz) > 0.0, 1.0, 0.0)

    # dielectric (material.cu:73-80, 102-136): Sellmeier n(hero)
    hero_um2 = (hero * 1e-3) ** 2
    n2 = (
        1.0
        + b0 * hero_um2 / (hero_um2 - sc0)
        + b1 * hero_um2 / (hero_um2 - sc1)
        + b2 * hero_um2 / (hero_um2 - sc2)
    )
    ir = jnp.sqrt(jnp.maximum(n2, 1e-6))
    ratio = jnp.where(best_front > 0.0, 1.0 / ir, ir)
    cos_t = jnp.minimum(-(ux * best_nx + uy * best_ny + uz * best_nz), 1.0)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
    schlick = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
    must_reflect = (ratio * sin_t > 1.0) | (schlick > u_c)
    # refract (vec3.cuh:198-205)
    px_ = ratio * (ux + cos_t * best_nx)
    py_ = ratio * (uy + cos_t * best_ny)
    pz_ = ratio * (uz + cos_t * best_nz)
    par = jnp.sqrt(jnp.maximum(1.0 - (px_ * px_ + py_ * py_ + pz_ * pz_), 0.0))
    gx = jnp.where(must_reflect, rx, px_ - par * best_nx)
    gy = jnp.where(must_reflect, ry, py_ - par * best_ny)
    gz = jnp.where(must_reflect, rz, pz_ - par * best_nz)
    refracted = is_diel * jnp.where(must_reflect, 0.0, 1.0)

    ndx = is_lamb * lx + is_metal * mx + is_diel * gx
    ndy = is_lamb * ly + is_metal * my + is_diel * gy
    ndz = is_lamb * lz + is_metal * mz + is_diel * gz

    eps_sign = 1.0 - 2.0 * refracted
    nox = hx + eps_sign * EPSILON * best_nx
    noy = hy + eps_sign * EPSILON * best_ny
    noz = hz + eps_sign * EPSILON * best_nz

    # wavelength bookkeeping + termination
    hit_b = hit > 0.0
    n_valid = jnp.where(hit_b & (refracted > 0.0), 1.0, n_valid)
    n_valid = jnp.where(hit_b & (is_metal > 0.0) & (metal_ok == 0.0), 0.0, n_valid)
    terminated = jnp.maximum(
        miss, hit * jnp.maximum(is_emis, is_metal * (1.0 - metal_ok))
    )
    new_alive = alive * (1.0 - terminated)

    frozen = alive == 0.0
    scat = (alive > 0.0) & (terminated == 0.0)
    ox = jnp.where(frozen, ox, nox)
    oy = jnp.where(frozen, oy, noy)
    oz = jnp.where(frozen, oz, noz)
    dx = jnp.where(scat, ndx, dx)
    dy = jnp.where(scat, ndy, dy)
    dz = jnp.where(scat, ndz, dz)
    power = jnp.where(frozen[:, None], power, new_power)
    return ox, oy, oz, dx, dy, dz, power, new_alive, n_valid


def _nearest_hit(tri_ref, n_tris, ox, oy, oz, dx, dy, dz):
    """Nearest-hit sweep over the packed triangle table (ops/intersect.py
    semantics: edge-functional inside test, two-sided, normal flipped
    toward the ray)."""
    zero = jnp.zeros_like(ox)

    def tri_body(t, best):
        best_t, best_hit, best_front, bnx, bny, bnz, best_mat = best
        base = t * TRI_PACK_WIDTH
        nx, ny, nz, dd = (
            tri_ref[base], tri_ref[base + 1], tri_ref[base + 2], tri_ref[base + 3]
        )
        nd = nx * dx + ny * dy + nz * dz
        no = nx * ox + ny * oy + nz * oz
        tt = (dd - no) / nd
        inside = None
        for k in range(3):
            g0 = tri_ref[base + 4 + 3 * k]
            g1 = tri_ref[base + 5 + 3 * k]
            g2 = tri_ref[base + 6 + 3 * k]
            cc = tri_ref[base + 13 + k]
            ao = g0 * ox + g1 * oy + g2 * oz + cc
            ad = g0 * dx + g1 * dy + g2 * dz
            ok = (ao + tt * ad) >= 0.0
            inside = ok if inside is None else inside & ok
        take = inside & (jnp.abs(nd) >= DENOM_EPS) & (tt >= 0.0) & (tt < best_t)
        front = jnp.where(nd < 0.0, 1.0, 0.0)
        sgn = 2.0 * front - 1.0  # flip normal toward the ray
        mat_i = tri_ref[base + 16].astype(jnp.int32)
        return (
            jnp.where(take, tt, best_t),
            jnp.where(take, 1.0, best_hit),
            jnp.where(take, front, best_front),
            jnp.where(take, sgn * nx, bnx),
            jnp.where(take, sgn * ny, bny),
            jnp.where(take, sgn * nz, bnz),
            jnp.where(take, mat_i, best_mat),
        )

    init = (
        jnp.full_like(ox, BIG), zero, zero, zero, zero, zero,
        jnp.zeros(ox.shape, jnp.int32),
    )
    return jax.lax.fori_loop(0, n_tris, tri_body, init)


def _megakernel(
    cam_ref,  # [20] camera scalars
    seed_ref,  # [1] int32 base seed
    tri_ref,  # [T * 17]
    mat_ref,  # [M * 16]
    tab_ref,  # [5 * 95] curve tables
    px_ref,  # [block] f32 pixel x
    py_ref,  # [block] f32 pixel y
    *rest,  # [rand_ref [spp, R, block]] + out x, y, z [block]
    n_tris,
    spp,
    bounces,
    injected,
):
    if injected:
        rand_ref, outx_ref, outy_ref, outz_ref = rest
    else:
        outx_ref, outy_ref, outz_ref = rest
    px = px_ref[...]
    py = py_ref[...]
    zero = jnp.zeros_like(px)
    n_draws = n_uniforms(bounces)

    # per-pixel stream key: one counter-based stream per (seed, pixel)
    pix = py.astype(jnp.int32) * 65536 + px.astype(jnp.int32)
    ray_key = _hash32(seed_ref[0] ^ _hash32(pix))

    cx, cy, cz = cam_ref[0], cam_ref[1], cam_ref[2]
    p0x, p0y, p0z = cam_ref[3], cam_ref[4], cam_ref[5]
    dux, duy, duz = cam_ref[6], cam_ref[7], cam_ref[8]
    dvx, dvy, dvz = cam_ref[9], cam_ref[10], cam_ref[11]
    ddux, dduy, dduz = cam_ref[12], cam_ref[13], cam_ref[14]
    ddvx, ddvy, ddvz = cam_ref[15], cam_ref[16], cam_ref[17]
    has_defocus = cam_ref[18]

    span = LAMBDA_MAX - LAMBDA_MIN
    lam_step = span / float(W)
    w_off = jax.lax.broadcasted_iota(jnp.int32, (1, WP), 1).astype(jnp.float32)

    def sample_body(s, acc):
        accx, accy, accz = acc

        def rnd(j):
            if injected:
                return rand_ref[s, j, :]
            ctr = (s * n_draws + j).astype(jnp.uint32)
            return _bits_to_uniform(_hash32(ray_key + ctr * jnp.uint32(0x9E3779B9)))

        # camera ray (get_ray, rendering.cu:66-87) with the thin-lens disk
        # (defocus_disk_sample, rendering.cu:42-47); the disk draws sit at
        # the tail of the draw order so pinhole streams are unchanged
        fx = px + (rnd(0) - 0.5)
        fy = py + (rnd(1) - 0.5)
        dr = jnp.sqrt(rnd(3 + 3 * bounces)) * has_defocus
        dth = (2.0 * 3.14159265358979) * rnd(4 + 3 * bounces)
        du_ = dr * jnp.cos(dth)
        dv_ = dr * jnp.sin(dth)
        ox = cx + du_ * ddux + dv_ * ddvx
        oy = cy + du_ * dduy + dv_ * ddvy
        oz = cz + du_ * dduz + dv_ * ddvz
        dx = p0x + fx * dux + fy * dvx - ox
        dy = p0y + fx * duy + fy * dvy - oy
        dz = p0z + fx * duz + fy * dvz - oz

        # hero wavelengths (spectrum.cu:31-48), fixed for the whole path
        hero = LAMBDA_MIN + span * rnd(2)
        lam = hero[:, None] + w_off * lam_step
        lam = jnp.where(lam > LAMBDA_MAX, lam - span, lam)
        d65 = _lerp_table(tab_ref, TAB_D65, lam)
        bg = _lerp_table(tab_ref, TAB_BG, lam)

        def bounce_body(b, st):
            ox, oy, oz, dx, dy, dz, power, alive, n_valid = st
            best_t, best_hit, best_front, bnx, bny, bnz, best_mat = _nearest_hit(
                tri_ref, n_tris, ox, oy, oz, dx, dy, dz
            )
            return _scatter_shade(
                ox, oy, oz, dx, dy, dz, power, alive, n_valid,
                best_t, best_hit, best_front, bnx, bny, bnz, best_mat,
                mat_ref, hero, lam, d65, bg,
                rnd(3 + 3 * b), rnd(4 + 3 * b), rnd(5 + 3 * b),
            )

        st = (
            ox, oy, oz, dx, dy, dz,
            jnp.ones_like(lam), zero + 1.0, zero + float(W),
        )
        ox, oy, oz, dx, dy, dz, power, alive, n_valid = jax.lax.fori_loop(
            0, bounces, bounce_body, st
        )
        # bounce-limit exhaustion contributes nothing (rendering.cu:38-39)
        n_valid = jnp.where(alive > 0.0, 0.0, n_valid)

        # XYZ integration (dev_spectrum_to_XYZ, color.cu:88-104)
        contrib = power * jnp.where(w_off < n_valid[:, None], lam_step, 0.0)
        sx = jnp.sum(contrib * _lerp_table(tab_ref, TAB_CIE_X, lam), axis=1)
        sy = jnp.sum(contrib * _lerp_table(tab_ref, TAB_CIE_Y, lam), axis=1)
        sz = jnp.sum(contrib * _lerp_table(tab_ref, TAB_CIE_Z, lam), axis=1)
        return accx + sx, accy + sy, accz + sz

    accx, accy, accz = jax.lax.fori_loop(0, spp, sample_body, (zero, zero, zero))
    outx_ref[...] = accx
    outy_ref[...] = accy
    outz_ref[...] = accz


@functools.partial(
    jax.jit, static_argnames=("spp", "bounces", "block", "interpret")
)
def render_rays_pallas(
    cam_vec: jnp.ndarray,  # [20] f32 camera scalars
    seed: jnp.ndarray,  # [] int32
    tri_pack: jnp.ndarray,  # [T * 17]
    mat_pack: jnp.ndarray,  # [M * 16]
    tables: jnp.ndarray,  # [5 * 95]
    px: jnp.ndarray,  # [N] f32
    py: jnp.ndarray,  # [N] f32
    spp: int,
    bounces: int,
    block: int = BLOCK,
    interpret: bool = False,
    rand: jnp.ndarray | None = None,  # [spp, n_uniforms, N] injected uniforms
) -> jnp.ndarray:
    """Accumulated XYZ [N, 3] for N pixel rays; N must divide by ``block``.

    ``rand=None`` draws from the in-kernel counter hash; an injected
    uniform array makes the output a fixed function of it (goldens).
    ``interpret=True`` runs the kernel through the Pallas interpreter;
    only tests ask for it."""
    n = px.shape[0]
    if n % block or block & (block - 1):
        raise ValueError(f"ray count {n} must divide the power-of-two block {block}")
    n_tris = tri_pack.shape[0] // TRI_PACK_WIDTH
    injected = rand is not None
    whole = pl.BlockSpec()
    rays = pl.BlockSpec((block,), lambda i: (i,))
    in_specs = [whole, whole, whole, whole, whole, rays, rays]
    args = [
        cam_vec.astype(jnp.float32),
        jnp.asarray(seed, jnp.int32).reshape(1),
        tri_pack,
        mat_pack,
        tables,
        px.astype(jnp.float32),
        py.astype(jnp.float32),
    ]
    if injected:
        in_specs.append(pl.BlockSpec((spp, rand.shape[1], block), lambda i: (0, 0, i)))
        args.append(rand.astype(jnp.float32))
    kernel = functools.partial(
        _megakernel, n_tris=n_tris, spp=spp, bounces=bounces, injected=injected
    )
    out = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((n,), jnp.float32)] * 3,
        grid=(n // block,),
        in_specs=in_specs,
        out_specs=[rays] * 3,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=max(1, block // 32), num_stages=1
        ),
        interpret=interpret,
        name="spectral_megakernel",
    )(*args)
    return jnp.stack(out, axis=-1)


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "bounces", "block", "interpret"),
)
def _render_chunk_pallas_jit(
    scene, cam_vec, seed, x0, y0, rand, width, height, spp, bounces, block,
    interpret,
):
    # x0/y0 are traced: a progressive render visits many chunk origins of
    # one shape, and the origin only offsets the pixel grid
    n = width * height
    pad = (-n) % block
    ys, xs = jnp.meshgrid(
        jnp.int32(y0) + jnp.arange(height, dtype=jnp.int32),
        jnp.int32(x0) + jnp.arange(width, dtype=jnp.int32),
        indexing="ij",
    )
    px = jnp.pad(xs.ravel(), (0, pad)).astype(jnp.float32)
    py = jnp.pad(ys.ravel(), (0, pad)).astype(jnp.float32)
    if rand is not None:
        rand = jnp.pad(rand, ((0, 0), (0, 0), (0, pad)))
    tri_pack, mat_pack, tables = pack_scene(scene)
    xyz = render_rays_pallas(
        cam_vec, seed, tri_pack, mat_pack, tables, px, py, spp, bounces,
        block, interpret, rand,
    )
    return xyz[:n].reshape(height, width, 3)


def render_chunk_pallas(
    scene, cam, seed: int, x0: int, y0: int, width: int, height: int,
    spp: int, bounces: int, block: int = BLOCK, interpret: bool = False,
    rand: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Accumulated-XYZ chunk [height, width, 3] via the megakernel.

    Same output contract as render.wavefront.render_chunk (the same
    estimator on another random stream). ``rand``: injected uniforms
    [spp, n_uniforms(bounces), width*height] in row-major pixel order.
    Dense scenes only (at most DENSE_CUTOFF triangles)."""
    if scene.num_tris > DENSE_CUTOFF:
        raise ValueError(
            f"the megakernel sweeps every triangle; {scene.num_tris} > "
            f"DENSE_CUTOFF={DENSE_CUTOFF} takes the XLA LBVH path"
        )
    if rand is not None and rand.shape != (spp, n_uniforms(bounces), width * height):
        raise ValueError(f"rand shape {rand.shape} != {(spp, n_uniforms(bounces), width * height)}")
    return _render_chunk_pallas_jit(
        scene, camera_vector(cam), jnp.int32(seed & 0x7FFFFFFF),
        jnp.int32(x0), jnp.int32(y0), rand, width, height, spp, bounces,
        block, interpret,
    )


__all__ = [
    "BLOCK",
    "camera_vector",
    "n_uniforms",
    "pack_scene",
    "render_chunk_pallas",
    "render_rays_pallas",
]
