"""sRGB -> reflectance/illuminance spectrum uplift (sigmoid-polynomial).

The reference uses pbrt-v4's precomputed [3][64][64][64][3] coefficient table
(reference: color/color_to_spectrum.cuh:69-219, table declared in
utils/srgb_to_spectrum.cuh:17-19; the 9.4 MB data blob is stripped from the
snapshot). The representation is: SPD(lambda) = sigmoid(c0*l^2 + c1*l + c2).

Redesign: instead of a trilinearly-interpolated lookup table we
*fit the three coefficients directly per color* with a batched, jit-compiled
Gauss-Newton solve on the same objective pbrt optimizes (CIE-Lab round-trip
error under D65). Scenes have O(10) distinct colors, so the fit is a
negligible one-time cost, is MORE accurate than the table (no interpolation
error), and keeps the whole pipeline differentiable w.r.t. the coefficients.

The gray fast path (r == g == b) is handled in closed form exactly as the
reference does (color_to_spectrum.cuh:79: c = (r - 1/2) / sqrt(r (1 - r)),
which makes sigmoid(c) == r identically; r == 0 / r == 1 hit the +-inf ->
0/1 branch of sigmoid_inf_check, color_to_spectrum.cuh:38-41).

SPD sampling semantics replicate the reference exactly: sample i is taken at
lambda_i = LAMBDA_MIN + i * (LAMBDA_MAX - LAMBDA_MIN) / N  (note: /N, not
/(N-1) -- color_to_spectrum.cuh:161,196), even though downstream
spectrum_interp assumes an /(N-1) grid. That slight mismatch is observable
reference behavior, so we keep it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.constants import (
    LAMBDA_MAX,
    LAMBDA_MIN,
    N_CIE_SAMPLES,
    cie_d65,
    cie_d65_normalized,
    cie_x,
    cie_y,
    cie_z,
    d65_xyz_to_srgb,
)
from .spectrum import spectrum_interp_shared

# Wavelengths at which material SPDs are tabulated (reference step = range/N)
SPD_LAMBDAS = jnp.asarray(
    LAMBDA_MIN
    + np.arange(N_CIE_SAMPLES, dtype=np.float32) * (LAMBDA_MAX - LAMBDA_MIN) / N_CIE_SAMPLES
)

# Fit wavelength grid: the full 5nm CIE grid (360, 365, ..., 830)
_FIT_LAMBDAS = jnp.asarray(np.linspace(LAMBDA_MIN, LAMBDA_MAX, N_CIE_SAMPLES, dtype=np.float32))

# Normalized polynomial basis for conditioning: u = (lambda - MID) / HALF
_MID = 0.5 * (LAMBDA_MIN + LAMBDA_MAX)
_HALF = 0.5 * (LAMBDA_MAX - LAMBDA_MIN)


def sigmoid(x: jnp.ndarray) -> jnp.ndarray:
    """Reference sigmoid with inf-check (color_to_spectrum.cuh:38-41)."""
    core = 0.5 * x / jnp.sqrt(1.0 + x * x) + 0.5
    return jnp.where(jnp.isposinf(x), 1.0, jnp.where(jnp.isneginf(x), 0.0, core))


def eval_sigmoid_poly(coeffs: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """SPD(lambda) = sigmoid(c0 lam^2 + c1 lam + c2).

    coeffs [..., 3] in pbrt order (c0 quadratic, c1 linear, c2 constant),
    lam broadcasts; matches reference polynomial() + sigmoid_inf_check
    (color_to_spectrum.cuh:154-157). Handles inf c2 (pure gray 0/1 colors).
    """
    c0, c1, c2 = coeffs[..., 0], coeffs[..., 1], coeffs[..., 2]
    x = (c0 * lam + c1) * lam + c2
    return sigmoid(x)


def _gray_coeffs(r: jnp.ndarray) -> jnp.ndarray:
    """Closed-form coefficients for gray colors; sigmoid(c2) == r exactly.

    Pure 0/1 grays saturate to +-1e6 rather than +-inf (the reference's
    sigmoid_inf_check branch, color_to_spectrum.cuh:38-41): in f32,
    0.5 * 1e6 / sqrt(1 + 1e12) + 0.5 == 1.0 exactly, and a finite value
    keeps autodiff NaN-free through the jnp.where one-hot blends.
    """
    denom = jnp.sqrt(jnp.maximum(r * (1.0 - r), 0.0))
    c2 = jnp.where(
        denom > 0.0,
        (r - 0.5) / jnp.maximum(denom, 1e-37),
        jnp.where(r >= 0.5, 1e6, -1e6),
    )
    z = jnp.zeros_like(r)
    return jnp.stack([z, z, c2], axis=-1)


# ---------------------------------------------------------------------------
# Gauss-Newton fit on the pbrt objective: match CIE Lab of the D65-lit
# spectrum against the target linear-sRGB color.
# ---------------------------------------------------------------------------

def _xyz_of_spd_fn(spd_vals: jnp.ndarray) -> jnp.ndarray:
    """Integrate SPD samples on the fit grid against CMFs x D65, normalized
    so SPD == 1 yields the D65 white point (Y = 1)."""
    w = jnp.stack([cie_x, cie_y, cie_z]) * cie_d65  # [3, 95]
    k = 1.0 / jnp.sum(cie_y * cie_d65)
    return k * (w @ spd_vals)


_D65_WHITE = None  # filled lazily (needs jnp ready)


def _lab_f(t: jnp.ndarray) -> jnp.ndarray:
    d = 6.0 / 29.0
    return jnp.where(t > d**3, jnp.cbrt(jnp.maximum(t, 1e-20)), t / (3 * d * d) + 4.0 / 29.0)


def _xyz_to_lab(xyz: jnp.ndarray, white: jnp.ndarray) -> jnp.ndarray:
    fx = _lab_f(xyz[..., 0] / white[0])
    fy = _lab_f(xyz[..., 1] / white[1])
    fz = _lab_f(xyz[..., 2] / white[2])
    return jnp.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], axis=-1)


def _srgb_linear_to_xyz(rgb: jnp.ndarray) -> jnp.ndarray:
    from ..utils.constants import d65_srgb_to_xyz

    return jnp.einsum("ij,...j->...i", d65_srgb_to_xyz, rgb)


def _table_to_cie_grid(spd_table: jnp.ndarray) -> jnp.ndarray:
    """Resample a 95-entry SPD *table* (tabulated at SPD_LAMBDAS, the
    reference's /N grid) onto the 5nm CIE grid with the renderer's
    spectrum_interp semantics (the /(N-1) lerp) — i.e. the SPD the
    renderer observes in expectation."""
    return spectrum_interp_shared(spd_table, _FIT_LAMBDAS)


def _residual(u_coeffs: jnp.ndarray, target_lab: jnp.ndarray, white: jnp.ndarray) -> jnp.ndarray:
    """Residual in Lab space for coefficients in the normalized-u basis.

    The objective is the RENDERER-VISIBLE color: sigmoid evaluated on the
    tabulation grid (SPD_LAMBDAS), then resampled exactly as the renderer's
    spectrum lookup does, then integrated against the CIE curves. This keeps
    the reference's observable grid quirk (SURVEY: /N tabulation read back
    with /(N-1) lerp) while making the roundtrip exact for the fitted color.
    """
    u = (SPD_LAMBDAS - _MID) / _HALF
    x = (u_coeffs[0] * u + u_coeffs[1]) * u + u_coeffs[2]
    spd = 0.5 * x / jnp.sqrt(1.0 + x * x) + 0.5
    xyz = _xyz_of_spd_fn(_table_to_cie_grid(spd))
    return _xyz_to_lab(xyz, white) - target_lab


@partial(jax.jit, static_argnames=("iters",))
def _fit_one(rgb: jnp.ndarray, iters: int = 48) -> jnp.ndarray:
    """Levenberg-Marquardt fit of normalized-basis coefficients for one
    linear-sRGB color. The system is square (3 Lab residuals, 3 coefficients)
    so each step is a damped 3x3 solve; convergence is quadratic and reaches
    ~1e-12 Lab MSE on in-gamut colors in well under ``iters`` steps. Returns
    coefficients in the RAW-lambda basis."""
    white = _xyz_of_spd_fn(jnp.ones(N_CIE_SAMPLES, jnp.float32))
    target_lab = _xyz_to_lab(_srgb_linear_to_xyz(rgb), white)

    m = jnp.clip(jnp.mean(rgb), 1e-4, 1.0 - 1e-4)
    k0 = (m - 0.5) / jnp.sqrt(m * (1.0 - m))
    # multi-start: flat, rising/falling edge (red/blue-ish), band/notch
    # (green/magenta-ish) sigmoid shapes — LM picks the best basin
    inits = jnp.stack(
        [
            jnp.array([0.0, 0.0, 1.0]) * k0,
            jnp.array([0.0, 20.0, 0.0]) + jnp.array([0.0, 0.0, 1.0]) * k0,
            jnp.array([0.0, -20.0, 0.0]) + jnp.array([0.0, 0.0, 1.0]) * k0,
            jnp.array([-25.0, 0.0, 10.0]) + jnp.array([0.0, 0.0, 1.0]) * k0,
            jnp.array([25.0, 0.0, -10.0]) + jnp.array([0.0, 0.0, 1.0]) * k0,
        ]
    ).astype(jnp.float32)

    def resid(c):
        return _residual(c, target_lab, white)

    eye = jnp.eye(3, dtype=jnp.float32)

    def solve_from(init):
        def step(carry, _):
            c, damp, best_c, best_l = carry
            r = resid(c)
            l = jnp.sum(r * r)
            improved = l < best_l
            best_c = jnp.where(improved, c, best_c)
            best_l = jnp.minimum(l, best_l)
            jac = jax.jacfwd(resid)(c)  # [3, 3]
            a = jac.T @ jac + damp * eye
            g = jac.T @ r
            c_new = c - jnp.linalg.solve(a, g)
            l_new = jnp.sum(resid(c_new) ** 2)
            accept = l_new < l
            damp = jnp.clip(jnp.where(accept, damp * 0.33, damp * 4.0), 1e-10, 1e8)
            c = jnp.where(accept, c_new, c)
            return (c, damp, best_c, best_l), None

        carry0 = (init, jnp.float32(1e-4), init, jnp.float32(jnp.inf))
        (c_fin, _, best_c, best_l), _ = jax.lax.scan(step, carry0, None, length=iters)
        l_fin = jnp.sum(resid(c_fin) ** 2)
        return jnp.where(l_fin < best_l, c_fin, best_c), jnp.minimum(l_fin, best_l)

    cs, ls = jax.vmap(solve_from)(inits)
    c = cs[jnp.argmin(ls)]

    # convert normalized-basis (a u^2 + b u + k, u = (l - MID)/HALF) to raw
    a, b, k = c[0], c[1], c[2]
    c0 = a / (_HALF * _HALF)
    c1 = b / _HALF - 2.0 * a * _MID / (_HALF * _HALF)
    c2 = a * _MID * _MID / (_HALF * _HALF) - b * _MID / _HALF + k
    return jnp.stack([c0, c1, c2])


_fit_cache: dict[bytes, np.ndarray] = {}
_disk_table: tuple[np.ndarray, np.ndarray] | None | bool = None  # lazy


def _load_disk_table():
    """Precomputed (rgb, coeffs) rows for the stock scene palettes
    (scripts/precompute_fits.py) — avoids paying the fit jit on every
    process start."""
    global _disk_table
    if _disk_table is None:
        import os

        path = os.path.join(os.path.dirname(__file__), "..", "data", "rgb2spec_fits.npz")
        try:
            z = np.load(path)
            _disk_table = (z["rgb"].astype(np.float32), z["coeffs"].astype(np.float32))
        except OSError:
            _disk_table = False
    return _disk_table or None


def _lookup_disk(batch: np.ndarray) -> np.ndarray | None:
    """Exact-match rows of ``batch`` [K, 3] against the disk table; returns
    coeffs [K, 3] or None if any row misses."""
    table = _load_disk_table()
    if table is None:
        return None
    rgb_t, co_t = table
    out = np.empty((batch.shape[0], 3), np.float32)
    for i, row in enumerate(batch):
        m = np.nonzero((rgb_t == row).all(axis=1))[0]
        if m.size == 0:
            return None
        out[i] = co_t[m[0]]
    return out


# ---------------------------------------------------------------------------
# General-color coefficient table (round 5): the reference's
# [3][64][64][64][3] trilinear lookup (color_to_spectrum.cuh:69-151),
# regenerated from THIS repo's fit by scripts/build_rgb2spec_table.py.
# Gives O(1) coefficients for ARBITRARY colors (the per-color LM fit
# stalls scene build for colors outside the stock palettes); the exact
# fit remains the high-accuracy path (RGB2SPEC_EXACT=1, or any color in
# the palette disk cache).
# ---------------------------------------------------------------------------

_coeff_table: tuple | None | bool = None  # lazy (data, scale)


def _load_coeff_table():
    global _coeff_table
    if _coeff_table is None:
        import os

        path = os.path.join(
            os.path.dirname(__file__), "..", "data", "rgb2spec_table.npz"
        )
        try:
            z = np.load(path)
            _coeff_table = (
                jnp.asarray(z["data"]),  # [3, N, N, N, 3]
                jnp.asarray(z["scale"]),  # [N]
            )
        except OSError:
            _coeff_table = False
    return _coeff_table or None


def lookup_sigmoid_coeffs(rgb: jnp.ndarray) -> jnp.ndarray:
    """Trilinear table fetch of sigmoid coefficients for [..., 3] colors —
    the reference's get_sigmoid_coeffs indexing exactly
    (color_to_spectrum.cuh:69-107): slice = argmax component, z on the
    non-uniform scale grid (searchsorted == FindInterval), x/y uniform
    relative grids, 8-corner lerp. Fully traceable/differentiable jnp.
    Gray inputs take the exact closed form. Raises if the table file is
    missing (scripts/build_rgb2spec_table.py generates it)."""
    table = _load_coeff_table()
    if table is None:
        raise FileNotFoundError(
            "rgb2spec_table.npz not found - run "
            "scripts/build_rgb2spec_table.py"
        )
    data, scale = table
    res = data.shape[1]
    rgb = jnp.asarray(rgb, jnp.float32)
    flat = rgb.reshape(-1, 3)
    r, g, b = flat[:, 0], flat[:, 1], flat[:, 2]
    # maxc via the reference's exact comparison chain
    maxc = jnp.where(
        r > g, jnp.where(r > b, 0, 2), jnp.where(g > b, 1, 2)
    )
    z = jnp.take_along_axis(flat, maxc[:, None], axis=1)[:, 0]
    zs = jnp.maximum(z, 1e-12)
    x = (
        jnp.take_along_axis(flat, ((maxc + 1) % 3)[:, None], axis=1)[:, 0]
        * (res - 1)
        / zs
    )
    y = (
        jnp.take_along_axis(flat, ((maxc + 2) % 3)[:, None], axis=1)[:, 0]
        * (res - 1)
        / zs
    )
    xi = jnp.clip(x.astype(jnp.int32), 0, res - 2)
    yi = jnp.clip(y.astype(jnp.int32), 0, res - 2)
    zi = jnp.clip(
        jnp.searchsorted(scale, z, side="right") - 1, 0, res - 2
    )
    dx = x - xi
    dy = y - yi
    dz = (z - scale[zi]) / (scale[zi + 1] - scale[zi])

    def co(ddx, ddy, ddz):
        return data[maxc, zi + ddz, yi + ddy, xi + ddx]  # [K, 3]

    def lerp(t, a, b_):
        return (1.0 - t) * a + t * b_

    d2 = dx[:, None]
    c = lerp(
        dz[:, None],
        lerp(
            dy[:, None],
            lerp(d2, co(0, 0, 0), co(1, 0, 0)),
            lerp(d2, co(0, 1, 0), co(1, 1, 0)),
        ),
        lerp(
            dy[:, None],
            lerp(d2, co(0, 0, 1), co(1, 0, 1)),
            lerp(d2, co(0, 1, 1), co(1, 1, 1)),
        ),
    )
    is_gray = (flat[:, 0] == flat[:, 1]) & (flat[:, 1] == flat[:, 2])
    out = jnp.where(is_gray[:, None], _gray_coeffs(flat[:, 0]), c)
    return out.reshape(rgb.shape)


def fit_sigmoid_coeffs(rgb: jnp.ndarray) -> jnp.ndarray:
    """Fit sigmoid-polynomial coefficients for a batch of linear-sRGB colors.

    rgb: [..., 3] in [0, 1]. Returns [..., 3] raw-lambda coefficients
    (pbrt order c0, c1, c2). Gray inputs take the exact closed form.
    Concrete inputs are memoized per process and consult the precomputed
    palette table first (exact fits for the stock scene colors), then the
    general-color trilinear table (O(1), any color) before paying the
    multi-start LM fit. RGB2SPEC_EXACT=1 skips the table.
    """
    import os

    rgb = jnp.asarray(rgb, jnp.float32)
    concrete = not isinstance(rgb, jax.core.Tracer)
    use_table = os.environ.get("RGB2SPEC_EXACT", "0") != "1"
    if concrete:
        key = np.asarray(rgb).tobytes()
        if key in _fit_cache:
            return jnp.asarray(_fit_cache[key]).reshape(rgb.shape)
        hit = _lookup_disk(np.asarray(rgb).reshape(-1, 3))
        if hit is not None:
            _fit_cache[key] = hit.reshape(rgb.shape)
            return jnp.asarray(_fit_cache[key])
        if use_table and _load_coeff_table() is not None:
            out = lookup_sigmoid_coeffs(rgb)
            _fit_cache[key] = np.asarray(out)
            return out
    batch = rgb.reshape(-1, 3)
    fitted = jax.vmap(_fit_one)(batch)
    gray = _gray_coeffs(batch[:, 0])
    is_gray = (batch[:, 0] == batch[:, 1]) & (batch[:, 1] == batch[:, 2])
    out = jnp.where(is_gray[:, None], gray, fitted)
    if concrete:
        _fit_cache[key] = np.asarray(out)
    return out.reshape(rgb.shape)


def srgb_to_spectrum(rgb: jnp.ndarray) -> jnp.ndarray:
    """Reflectance SPD [..., 95] for linear-sRGB colors [..., 3].

    Reference: color_to_spectrum.cuh:188-219 (dev_srgb_to_spectrum)."""
    coeffs = fit_sigmoid_coeffs(rgb)
    return eval_sigmoid_poly(coeffs[..., None, :], SPD_LAMBDAS)


def srgb_to_illuminance_spectrum(rgb: jnp.ndarray, power: jnp.ndarray | float = 1.0) -> jnp.ndarray:
    """Illuminance SPD [..., 95]: power^2 * sigmoid-SPD * normalized D65.

    Reference: color_to_spectrum.cuh:158-186."""
    coeffs = fit_sigmoid_coeffs(rgb)
    base = eval_sigmoid_poly(coeffs[..., None, :], SPD_LAMBDAS)
    d65 = spectrum_interp_shared(cie_d65_normalized, SPD_LAMBDAS)
    power = jnp.asarray(power, jnp.float32)
    return (power**2)[..., None] * base * d65 if power.ndim else power**2 * base * d65


def spd_from_coeffs_reflectance(coeffs: jnp.ndarray) -> jnp.ndarray:
    """Differentiable SPD tabulation from coefficients (inverse rendering)."""
    return eval_sigmoid_poly(coeffs[..., None, :], SPD_LAMBDAS)


def spd_from_coeffs_illuminance(coeffs: jnp.ndarray, power: jnp.ndarray) -> jnp.ndarray:
    d65 = spectrum_interp_shared(cie_d65_normalized, SPD_LAMBDAS)
    return (power**2)[..., None] * eval_sigmoid_poly(coeffs[..., None, :], SPD_LAMBDAS) * d65


def roundtrip_srgb(spd: jnp.ndarray) -> jnp.ndarray:
    """Render an SPD *table* [..., 95] (tabulated on SPD_LAMBDAS) under D65
    back to linear sRGB through the renderer's resampling semantics -- the
    fit's acceptance metric."""
    flat = spd.reshape(-1, spd.shape[-1])
    resampled = jax.vmap(_table_to_cie_grid)(flat).reshape(spd.shape)
    w = jnp.stack([cie_x, cie_y, cie_z]) * cie_d65
    k = 1.0 / jnp.sum(cie_y * cie_d65)
    xyz = k * jnp.einsum("cs,...s->...c", w, resampled)
    return jnp.einsum("ij,...j->...i", d65_xyz_to_srgb, xyz)
