"""Converged-image parity contract, CI-runnable downsampled version.

The on-card contract (chip_smoke.py phase 5) compares the XLA wavefront
and the megakernel at 128x128/256spp on the GPU; here the same
noise-floor-relative methodology runs on CPU, with the kernel in interpret
mode on its own counter-hash stream, at a size the suite can afford: the
kernel-vs-XLA block-downsampled error must not exceed 1.2x the XLA-vs-XLA
reseed error, and mean luminance must agree to 2.5%. (The CI thresholds
are looser than the on-card contract's 1.1x/2% because the small CI
sample count makes the ratio itself noisy.)

Reference semantics: rendering/rendering.cu:151-235 (the estimator both
paths implement); tolerance contract per SURVEY.md section 6.
"""

import jax
import numpy as np
import pytest

from spectral_tpu.models.scenes import CORNELL, PRISM, build_scene, scene_camera
from spectral_tpu.ops.pallas.render_kernel import render_chunk_pallas
from spectral_tpu.render.wavefront import render_chunk

SIZE, SPP, BL, CH = 64, 128, 5, 16


def _down(img, b=8):
    h, w, c = img.shape
    return img.reshape(h // b, b, w // b, b, c).mean((1, 3))


def _rel(a, b):
    da, db = _down(a), _down(b)
    return float(
        (np.abs(da - db).sum(-1) / (np.abs(da).sum(-1) + 1e-3)).mean()
    )


@pytest.mark.parametrize("sid", [CORNELL, PRISM])
def test_cross_path_error_at_noise_floor(sid):
    scene = build_scene(sid)
    cam = scene_camera(sid, SIZE, SIZE)

    def xla_img(base):
        acc = 0
        for i in range(SPP // CH):
            acc = acc + render_chunk(
                scene, cam, jax.random.PRNGKey(base + i), 0, 0, SIZE, SIZE, CH, BL
            )
        return np.asarray(acc) / SPP

    def pal_img(base):
        acc = 0
        for i in range(SPP // CH):
            acc = acc + render_chunk_pallas(
                scene, cam, base + i, 0, 0, SIZE, SIZE, CH, BL, interpret=True,
            )
        return np.asarray(acc) / SPP

    x1 = xla_img(100)
    x2 = xla_img(900)
    p1 = pal_img(4242)

    noise = _rel(x1, x2)
    cross = _rel(p1, 0.5 * (x1 + x2))
    lum = p1[..., 1].mean() / max(0.5 * (x1 + x2)[..., 1].mean(), 1e-9)
    assert cross <= 1.2 * noise, (cross, noise)
    # CI sample counts make mean luminance itself ~1% noisy at 128 spp;
    # the 2% contract holds on the card at 256 spp (chip_smoke.py)
    assert 0.975 <= lum <= 1.025, lum
