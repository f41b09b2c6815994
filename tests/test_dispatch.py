"""Choice of compute path: one rule from platform, triangle count and
``impl`` (runtime/render_manager.py::select_impl), with no silent
fallback."""

from __future__ import annotations

import jax
import pytest

from spectral_tpu.config import RenderParams
from spectral_tpu.models.scenes import CORNELL, build_scene, scene_camera
from spectral_tpu.runtime.render_manager import RenderManager, select_impl
from spectral_tpu.utils.constants import DENSE_CUTOFF


@pytest.mark.parametrize(
    "impl,platform,n_tris,expected",
    [
        ("auto", "gpu", 42, "pallas"),
        ("auto", "gpu", DENSE_CUTOFF, "pallas"),
        ("auto", "gpu", DENSE_CUTOFF + 1, "xla"),
        ("auto", "gpu", 10008, "xla"),
        ("auto", "cpu", 42, "xla"),
        ("xla", "gpu", 42, "xla"),
        ("pallas", "gpu", 20, "pallas"),
    ],
)
def test_select_impl(impl, platform, n_tris, expected):
    assert select_impl(impl, n_tris, platform) == expected


@pytest.mark.parametrize(
    "impl,platform,n_tris",
    [("pallas", "cpu", 42), ("pallas", "gpu", 10008), ("mxu", "gpu", 42)],
)
def test_select_impl_refuses(impl, platform, n_tris):
    with pytest.raises(ValueError):
        select_impl(impl, n_tris, platform)


def test_render_manager_on_cpu():
    """auto renders through XLA here; an explicit pallas refuses instead of
    falling back to the interpreter."""
    scene = build_scene(CORNELL)
    p = RenderParams(xres=8, nsamples=1, bounce_limit=1)
    rm = RenderManager(scene, scene_camera(CORNELL, 8, 8), p)
    assert rm.impl == ("pallas" if jax.default_backend() == "gpu" else "xla")
    assert rm.render(jax.random.PRNGKey(0)).shape == (8, 8, 3)
    if jax.default_backend() != "gpu":
        with pytest.raises(ValueError, match="GPU"):
            RenderManager(scene, scene_camera(CORNELL, 8, 8), RenderParams(xres=8, impl="pallas"))
