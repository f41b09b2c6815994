"""spectral_tpu — a differentiable spectral path tracer in JAX.

A from-scratch JAX/Pallas framework with the capabilities of the CUDA
reference (PieSil/CUDA-spectral-ray-tracer): hero-wavelength spectral path
tracing of triangle scenes with lambertian / metallic / dielectric
(Sellmeier-dispersive) / emissive materials, sRGB<->spectrum conversion
through CIE XYZ, progressive chunked rendering — plus capabilities the
reference lacks: exact autodiff through the light path (inverse rendering
of material spectra and dispersion), multi-device tile/sample sharding on
a device mesh, tile checkpoint/resume, and a Pallas (Triton) megakernel
forward path for GPUs.

Public API:

    from spectral_tpu import (
        build_scene, scene_camera, render_chunk, RenderManager,
        RenderParams, parse_args,
    )
"""

import jax as _jax

# f32 contractions may otherwise run in reduced precision (TF32 on GPU
# tensor cores). The intersector's 3-wide edge functionals
# (ops/intersect.py) and the 3x3 color transforms need full f32: reduced
# precision misclassifies grazing interior tests and visibly darkens
# renders (hits silently dropped). Rendering is f32-semantics throughout.
_jax.config.update("jax_default_matmul_precision", "highest")

from .config import RenderParams, parse_args
from .models.camera import Camera, generate_rays, make_camera
from .models.scenes import (
    CORNELL,
    PRISM,
    SCENE_NAMES,
    TRIS,
    Scene,
    build_scene,
    expected_sizes,
    scene_camera,
)
from .render.wavefront import render_chunk, xyz_to_image

__version__ = "0.1.0"

__all__ = [
    "RenderParams",
    "parse_args",
    "Camera",
    "make_camera",
    "generate_rays",
    "CORNELL",
    "PRISM",
    "TRIS",
    "SCENE_NAMES",
    "Scene",
    "build_scene",
    "expected_sizes",
    "scene_camera",
    "render_chunk",
    "xyz_to_image",
    "__version__",
]


def __getattr__(name):
    # heavier subsystems load lazily to keep bare import fast
    if name == "RenderManager":
        from .runtime.render_manager import RenderManager

        return RenderManager
    raise AttributeError(name)
