"""Throughput harness: spectral path tracing on one GPU.

Prints ONE JSON line: the device record (platform, device kind, device
count, the card's name and power limit from nvidia-smi) and one entry per
row. Every forward row renders through ``RenderManager`` on the compute
path that ``auto`` picks (runtime/render_manager.py::select_impl: the
Pallas megakernel for dense scenes on a GPU, the XLA wavefront with an
LBVH for large ones); the gradient row is one jitted ``jax.value_and_grad``
step of the XLA wavefront. Rates are Mray-steps/s = W*H*spp*bounces over
the best wall time of a few renders after a compiling warm-up, host
readback and sRGB encode included.

A row that fails fails the run. There is no fallback to the CPU: on any
other platform the harness exits non-zero before rendering.

This is a harness, not yet a benchmark: cells, metrics and regression
bounds come with BENCHMARK.json.

Usage: python bench.py [row ...]   (default: every row)
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

REPS = 3


def device_record() -> dict:
    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "nvidia_smi": smi,
    }


def _best_time(fn) -> float:
    fn()  # warm-up: compiles every shape the timed runs use
    best = float("inf")
    for rep in range(REPS):
        t0 = time.perf_counter()
        fn(rep)
        best = min(best, time.perf_counter() - t0)
    return best


def frame_row(scene, sid, width, height, spp, bounces, chunk_rows) -> dict:
    """One full frame through RenderManager on the ``auto`` path."""
    from spectral_tpu.config import RenderParams
    from spectral_tpu.models.scenes import scene_camera
    from spectral_tpu.runtime.render_manager import RenderManager

    params = RenderParams(
        scene=sid, xres=width, aspect_ratio=width / height, xcsize=width,
        ycsize=chunk_rows, nsamples=spp, bounce_limit=bounces,
    )
    assert params.yres == height, (params.yres, height)
    rm = RenderManager(scene, scene_camera(sid, width, height), params)

    def run(rep=-1):
        img = rm.render(jax.random.PRNGKey(100 + rep))
        if not (img.shape == (height, width, 3) and img.max() > 0):
            raise RuntimeError(f"bad frame {img.shape} max {img.max()}")

    dt = _best_time(run)
    return {
        "path": rm.impl,
        "shape": [width, height, spp, bounces, chunk_rows],
        "seconds": dt,
        "mray_steps_per_s": width * height * spp * bounces / dt / 1e6,
    }


def grad_row(scene, width=512, height=256, spp=4, bounces=6) -> dict:
    """One value-and-gradient step of the XLA wavefront w.r.t. the
    material coefficients and emission powers (LBVH path above the
    dense cutoff)."""
    from spectral_tpu.models.scenes import CORNELL, auto_bvh, scene_camera
    from spectral_tpu.parallel import apply_params, trainable_params
    from spectral_tpu.render.wavefront import render_chunk

    scene = auto_bvh(scene)
    cam = scene_camera(CORNELL, width, height)
    target = render_chunk(scene, cam, jax.random.PRNGKey(99), 0, 0, width, height, spp, bounces)
    p0 = trainable_params(scene)
    params = {"coeffs": p0["coeffs"] + 0.1, "emission_power": p0["emission_power"]}

    @jax.jit
    def step(params, key):
        def loss(p):
            s = apply_params(scene, dict(p0, **p))
            img = render_chunk(s, cam, key, 0, 0, width, height, spp, bounces)
            return jnp.mean((img - target) ** 2)

        return jax.value_and_grad(loss)(params)

    def run(rep=-1):
        loss, g = step(params, jax.random.PRNGKey(7 + rep))
        jax.block_until_ready(g)
        if not (jnp.isfinite(loss) and all(jnp.isfinite(v).all() for v in g.values())):
            raise RuntimeError("non-finite gradient step")

    dt = _best_time(run)
    return {
        "path": "xla",
        "shape": [width, height, spp, bounces],
        "step_ms": dt * 1e3,
        "mray_steps_per_s": width * height * spp * bounces / dt / 1e6,
    }


def rows() -> dict:
    from spectral_tpu.models.scenes import CORNELL, build_scene, build_tri_field

    cornell = build_scene(CORNELL)
    return {
        "cornell_1080p_16spp": lambda: frame_row(cornell, CORNELL, 1920, 1080, 16, 8, 135),
        "cornell_1080p_256spp": lambda: frame_row(cornell, CORNELL, 1920, 1080, 256, 10, 135),
        "field10k": lambda: frame_row(build_tri_field(10008), CORNELL, 512, 256, 4, 6, 256),
        "field50k": lambda: frame_row(build_tri_field(50016), CORNELL, 512, 256, 4, 6, 256),
        "field200k": lambda: frame_row(build_tri_field(200064), CORNELL, 512, 256, 4, 6, 256),
        "grad_field10k": lambda: grad_row(build_tri_field(10008)),
    }


def main(argv: list[str]) -> int:
    from spectral_tpu.utils.compile_cache import configure_compile_cache

    if jax.devices()[0].platform != "gpu":
        print(f"bench.py needs a GPU; found {jax.devices()[0].platform}", file=sys.stderr)
        return 2
    configure_compile_cache()
    table = rows()
    record = {"device": device_record(), "rows": {}}
    for name in argv or list(table):
        record["rows"][name] = table[name]()
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
