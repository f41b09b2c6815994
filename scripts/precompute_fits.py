"""Precompute sigmoid-polynomial fits for the stock scene palettes.

Writes spectral_tpu/data/rgb2spec_fits.npz with (rgb, coeffs) rows for
every color used by the three hard-coded scenes plus common calibration
colors, so process startup never pays the fit compile.

Run: JAX_PLATFORMS=cpu python scripts/precompute_fits.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

# the palette must hold EXACT LM fits — without this the fit would route
# through the 64^3 table (round 5) and bake interpolation error into the
# stock-scene palette (it did, once: golden images moved by 7.6e-3)
os.environ["RGB2SPEC_EXACT"] = "1"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp  # noqa: E402

from spectral_tpu.ops.rgb2spec import (  # noqa: E402
    fit_sigmoid_coeffs,
    roundtrip_srgb,
    srgb_to_spectrum,
)

# every rgb used in models/scenes.py builders + calibration set
PALETTE = [
    (0.65, 0.05, 0.05),  # red
    (0.12, 0.45, 0.15),  # green
    (0.73, 0.73, 0.73),  # white walls
    (1.0, 1.0, 1.0),  # light + dielectric rgb
    (0.5, 0.5, 0.5),  # metal
    (0.12, 0.15, 0.45),  # blue
    (0.7, 0.7, 0.7),  # metal2
    (0.0, 0.0, 0.0),  # background black
    (0.2, 0.2, 0.2),
    (0.9, 0.9, 0.9),
    (0.25, 0.5, 0.75),
    (0.8, 0.6, 0.2),
    # round 5: field/example/test palettes — keeping every stock color
    # on the EXACT palette path preserves golden images now that
    # non-palette concrete colors route through the 64^3 table
    (0.8, 0.85, 0.88),  # field metal
    (0.2, 0.3, 0.6),  # vwarp blue
    (0.8, 0.8, 0.8),
    (0.05, 0.05, 0.05),
    (0.1, 0.1, 0.1),
    (0.35, 0.55, 0.9),
    (0.5, 0.6, 0.8),
    (0.0, 0.0, 0.5),
    (0.0, 1.0, 0.0),
    (0.5, 0.0, 0.0),
]


def main() -> None:
    # remove the existing palette FIRST: fit_sigmoid_coeffs consults it
    # before fitting, so regeneration would otherwise read back whatever
    # the old file contained instead of refitting
    out = os.path.join(
        os.path.dirname(__file__), "..", "spectral_tpu", "data",
        "rgb2spec_fits.npz",
    )
    if os.path.exists(out):
        os.remove(out)
    rgb = np.asarray(PALETTE, np.float32)
    coeffs = np.asarray(fit_sigmoid_coeffs(jnp.asarray(rgb)), np.float32)
    spd = srgb_to_spectrum(jnp.asarray(rgb))
    rt = np.asarray(roundtrip_srgb(spd))
    err = np.abs(rt - rgb).max(axis=1)
    for c, e in zip(PALETTE, err):
        print(f"  {c} roundtrip max err {e:.2e}")
    out = os.path.join(
        os.path.dirname(__file__), "..", "spectral_tpu", "data", "rgb2spec_fits.npz"
    )
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez(out, rgb=rgb, coeffs=coeffs)
    print("wrote", os.path.normpath(out), f"({len(PALETTE)} colors)")


if __name__ == "__main__":
    main()
