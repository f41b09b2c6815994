"""Time the megakernel against the XLA wavefront end to end on one GPU.

Both paths render the same frames through ``RenderManager`` (host readback
and sRGB encode included), in the order xla, pallas, pallas, xla after one
compiling warm-up each, at the two dense configurations that decide
whether the kernel stays:

- Cornell 1920x1080, 16 spp, 8 bounces, in 135-row chunks;
- prism 512x512, 64 spp, 10 bounces, one chunk.

Prints one line per render and one JSON summary line (best seconds and
Mray-steps/s per path and configuration, with nvidia-smi's name and power
limit).

Usage: python scripts/compare_paths.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from spectral_tpu.config import CORNELL, PRISM, RenderParams  # noqa: E402
from spectral_tpu.models.scenes import build_scene, scene_camera  # noqa: E402
from spectral_tpu.runtime.render_manager import RenderManager  # noqa: E402
from spectral_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

CONFIGS = {
    "cornell_1080p_16spp_8b": (CORNELL, 1920, 1080, 16, 8, 135),
    "prism_512_64spp_10b": (PRISM, 512, 512, 64, 10, 512),
}


def main() -> int:
    if jax.devices()[0].platform != "gpu":
        print("compare_paths.py needs a GPU", file=sys.stderr)
        return 2
    configure_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    summary = {"card": smi, "kind": jax.devices()[0].device_kind}
    for name, (sid, w, h, spp, bounces, rows) in CONFIGS.items():
        scene, cam = build_scene(sid), scene_camera(sid, w, h)
        managers = {
            impl: RenderManager(scene, cam, RenderParams(
                scene=sid, xres=w, aspect_ratio=w / h, xcsize=w, ycsize=rows,
                nsamples=spp, bounce_limit=bounces, impl=impl,
            ))
            for impl in ("xla", "pallas")
        }
        for impl, rm in managers.items():
            t0 = time.perf_counter()
            rm.render(jax.random.PRNGKey(0))
            print(f"{name} {impl} warm-up (compile + render) {time.perf_counter() - t0:.3f} s", flush=True)
        best = {}
        for rep, impl in enumerate(("xla", "pallas", "pallas", "xla")):
            t0 = time.perf_counter()
            managers[impl].render(jax.random.PRNGKey(1 + rep))
            dt = time.perf_counter() - t0
            best[impl] = min(best.get(impl, dt), dt)
            print(f"{name} {impl} {dt:.6f} s {w * h * spp * bounces / dt / 1e6:.1f} Mray-steps/s", flush=True)
        summary[name] = {
            impl: {"seconds": t, "mray_steps_per_s": w * h * spp * bounces / t / 1e6}
            for impl, t in best.items()
        }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
