"""Smoke test of the main paths on one NVIDIA GPU (or four, with --four).

Run from the root of a checkout:

    python chip_smoke.py          # one card: phases 1-6
    python chip_smoke.py --four   # four cards: the sharded path only

Phases (one card):
  1. device   — JAX must see a GPU; prints nvidia-smi's name and power
                limit, the device kind and the JAX version.
  2. cli      — ``python -m spectral_tpu.main`` in-process at the
                reference defaults (Cornell, 600x600, 500 spp, 10 bounces,
                --save --no-show --do-log), twice (cold, then warm).
  3. scenes   — the dispersive prism and the mixed scene at 512x512/64 spp.
  4. field    — a 10k-triangle field through ``render_chunk`` at
                512x256/4 spp/6 bounces (the LBVH path via auto_bvh), and
                LBVH-vs-dense nearest hits on 4,096 random rays.
  5. kernel   — the megakernel against the XLA wavefront at 128x128/256 spp
                under the noise-floor contract, and against the committed
                goldens under injected uniforms.
  6. inverse  — five SGD steps of ``parallel.train_step`` from a perturbed
                wall spectrum; one gradient against a finite difference.
With --four: ``render_image_sharded`` and ``train_step`` on a (2, 2) mesh
of four cards against the one-card render.

Every failure propagates: a failed phase exits non-zero and prints no ok
line. The last line is the JSON device record.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(*args):
    print(*args, flush=True)


def phase(name):
    def wrap(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            log(f"== {name}")
            out = fn(*a, **k)
            log(f"== {name} ok ({time.perf_counter() - t0:.1f} s)")
            return out

        return run

    return wrap


@phase("device")
def device_phase(n_cards):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})")
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"device_kind={devs[0].device_kind} count={len(devs)} jax={jax.__version__}")
    return smi.splitlines()[0]


def _light_region(cam):
    """Pixel box of the Cornell ceiling light (scenes._cornell_walls),
    projected through the camera frame."""
    c = np.asarray(cam.center, np.float64)
    p00 = np.asarray(cam.pixel00_loc, np.float64)
    du = np.asarray(cam.pixel_delta_u, np.float64)
    dv = np.asarray(cam.pixel_delta_v, np.float64)
    cols, rows = [], []
    for x in (237.5, 317.5):  # the 100x100 quad, shrunk by 10 on each side
        for z in (237.5, 317.5):
            v = np.array([x, 554.0, z]) - c
            # c + s v = p00 + i du + j dv
            s, i, j = np.linalg.solve(np.stack([v, -du, -dv], 1), p00 - c)
            cols.append(i)
            rows.append(j)
    return int(min(rows)) + 1, int(max(rows)), int(min(cols)) + 1, int(max(cols))


def _read_bmp(path):
    """24-bit bottom-up BGR BMP -> [H, W, 3] RGB uint8."""
    raw = open(path, "rb").read()
    off = int.from_bytes(raw[10:14], "little")
    w = int.from_bytes(raw[18:22], "little", signed=True)
    h = int.from_bytes(raw[22:26], "little", signed=True)
    stride = (w * 3 + 3) & ~3
    rows = np.frombuffer(raw[off : off + stride * h], np.uint8).reshape(h, stride)
    return rows[::-1, : w * 3].reshape(h, w, 3)[..., ::-1]


@phase("cli")
def cli_phase(card):
    from spectral_tpu import main as cli
    from spectral_tpu.models.scenes import scene_camera
    from spectral_tpu.utils.logging import get_log_context

    argv = ["-s", "0", "-xr", "600", "-ns", "500", "-bl", "10",
            "--save", "--no-show", "--do-log", "-t", "chip_smoke"]
    for attempt in ("cold", "warm"):
        t0 = time.perf_counter()
        assert cli.main(argv) == 0
        wall = time.perf_counter() - t0
        ctx = get_log_context()
        render_s = float(ctx.get("total rendering time (seconds)"))
        assert ctx.get("compute path") == "pallas", ctx.get("compute path")
        assert ctx.get("non-finite values") == "0", ctx.get("non-finite values")
        log(f"cli {attempt}: wall {wall:.3f} s, render {render_s:.3f} s, "
            f"{600 * 600 * 500 * 10 / render_s / 1e6:.1f} Mray-steps/s ({card})")
    bmp = max(glob.glob(os.path.join("renders", "*_chip_smoke.bmp")), key=os.path.getmtime)
    img = _read_bmp(bmp).astype(np.float64)
    assert img.shape == (600, 600, 3), img.shape
    r0, r1, c0, c1 = _light_region(scene_camera(0, 600, 600))
    mask = np.zeros(img.shape[:2], bool)
    mask[r0:r1, c0:c1] = True
    light, rest = img[mask].mean(), img[~mask].mean()
    log(f"{bmp}: light rows {r0}:{r1} cols {c0}:{c1} mean {light:.1f}, rest {rest:.1f}")
    assert light > 200.0 and rest > 5.0 and light > 3.0 * rest


@phase("scenes")
def scenes_phase():
    import jax

    from spectral_tpu.config import PRISM, TRIS, RenderParams
    from spectral_tpu.models.scenes import build_scene, scene_camera
    from spectral_tpu.runtime.render_manager import RenderManager

    for sid in (PRISM, TRIS):
        p = RenderParams(scene=sid, xres=512, nsamples=64)
        rm = RenderManager(build_scene(sid), scene_camera(sid, 512, 512), p)
        t0 = time.perf_counter()
        img = rm.render(jax.random.PRNGKey(sid))
        xyz = rm.xyz
        log(f"scene {sid}: {rm.impl}, {time.perf_counter() - t0:.3f} s, "
            f"mean Y {xyz[..., 1].mean() / 64:.4f}, max sRGB {img.max()}")
        assert np.isfinite(xyz).all() and xyz[..., 1].mean() > 0.0 and img.max() > 0


@phase("field")
def field_phase():
    import jax
    import jax.numpy as jnp

    from spectral_tpu.models.scenes import CORNELL, build_tri_field, scene_camera, with_bvh
    from spectral_tpu.ops.bvh import nearest_hit_bvh
    from spectral_tpu.ops.intersect import nearest_hit
    from spectral_tpu.render.wavefront import render_chunk

    field = build_tri_field(10008, seed=0)
    assert field.bvh is None  # render_chunk attaches the LBVH itself
    cam = scene_camera(CORNELL, 512, 256)
    for rep in range(2):
        t0 = time.perf_counter()
        out = np.asarray(render_chunk(field, cam, jax.random.PRNGKey(rep), 0, 0, 512, 256, 4, 6))
        dt = time.perf_counter() - t0
        log(f"field10k {'cold' if rep == 0 else 'warm'}: {dt:.3f} s, "
            f"{512 * 256 * 4 * 6 / dt / 1e6:.2f} Mray-steps/s, mean Y {out[..., 1].mean():.4f}")
        assert np.isfinite(out).all() and out[..., 1].mean() > 0.0
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    log(f"peak device bytes so far {peak}")
    # a dense [N, T] sweep of 512x256 rays against 10k triangles needs ~21 GB
    assert peak < 8e9, peak

    accel = with_bvh(field)
    rng = np.random.default_rng(0)
    o = jnp.asarray(rng.uniform(20.0, 535.0, (4096, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(4096, 3)), jnp.float32)
    a = jax.jit(nearest_hit_bvh)(o, d, accel, accel.bvh)
    b = jax.jit(nearest_hit)(o, d, field)
    hit = np.asarray(b.hit)
    same_idx = np.asarray(a.tri_index)[hit] == np.asarray(b.tri_index)[hit]
    t_rel = np.abs(np.asarray(a.t)[hit] - np.asarray(b.t)[hit]) / np.asarray(b.t)[hit]
    log(f"lbvh vs dense: {hit.sum()} hits, hit/miss equal {bool((np.asarray(a.hit) == hit).all())}, "
        f"index equal {same_idx.mean():.5f}, t max rel {t_rel.max():.2e}")
    # tolerance: identical hit/miss; t to 1e-5 relative (f32 rounding of
    # the same plane equation); index equal but for exact t ties
    assert (np.asarray(a.hit) == hit).all()
    assert t_rel.max() <= 1e-5 and same_idx.mean() >= 0.999


def _down(img, b=8):
    h, w, c = img.shape
    return img.reshape(h // b, b, w // b, b, c).mean((1, 3))


def _rel(a, b):
    da, db = _down(a), _down(b)
    return float((np.abs(da - db).sum(-1) / (np.abs(da).sum(-1) + 1e-3)).mean())


@phase("kernel")
def kernel_phase():
    """Precision: fp32 kernel; the XLA reference runs with
    jax_default_matmul_precision="highest" (spectral_tpu/__init__.py), so
    neither side uses TF32."""
    import jax

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_goldens import MEGAKERNEL_GOLDENS, render_megakernel_golden

    from spectral_tpu.models.scenes import CORNELL, PRISM, build_scene, scene_camera
    from spectral_tpu.ops.pallas.render_kernel import render_chunk_pallas
    from spectral_tpu.render.wavefront import render_chunk

    assert jax.config.jax_default_matmul_precision == "highest"
    size, spp, bounces = 128, 256, 10
    for sid in (CORNELL, PRISM):
        scene, cam = build_scene(sid), scene_camera(sid, size, size)
        x1 = np.asarray(render_chunk(scene, cam, jax.random.PRNGKey(1), 0, 0, size, size, spp, bounces)) / spp
        x2 = np.asarray(render_chunk(scene, cam, jax.random.PRNGKey(2), 0, 0, size, size, spp, bounces)) / spp
        k = np.asarray(render_chunk_pallas(scene, cam, 4242, 0, 0, size, size, spp, bounces)) / spp
        noise, cross = _rel(x1, x2), _rel(k, 0.5 * (x1 + x2))
        lum = k[..., 1].mean() / (0.5 * (x1 + x2))[..., 1].mean()
        log(f"parity scene {sid}: noise {noise:.4f} cross {cross:.4f} "
            f"ratio {cross / noise:.3f} (<= 1.1) luminance {lum:.4f} (within 2%)")
        assert np.isfinite(k).all() and cross <= 1.1 * noise and abs(lum - 1.0) <= 0.02

    # goldens under injected uniforms. Tolerance: at least 99% of values
    # within rtol 1e-4 / atol 1e-5 and image sums within 2%; the rest are
    # whole paths that took the other branch of a dielectric or grazing
    # decision because the GPU rounds (fused multiply-add, libdevice
    # transcendentals) unlike the CPU interpreter that wrote the goldens
    for name in sorted(MEGAKERNEL_GOLDENS) + ["cornell_pallas_24px.npy"]:
        ref = np.load(os.path.join(ROOT, "tests", "goldens", name))
        if name == "cornell_pallas_24px.npy":
            from spectral_tpu.ops.pallas.render_kernel import n_uniforms

            rand = jax.random.uniform(jax.random.PRNGKey(42), (4, n_uniforms(3), 1024))[:, :, :576]
            img = np.asarray(render_chunk_pallas(
                build_scene(CORNELL), scene_camera(CORNELL, 24, 24), 9, 0, 0, 24, 24, 4, 3, rand=rand))
        else:
            img = render_megakernel_golden(name, interpret=False)
        off = float((~np.isclose(img, ref, rtol=1e-4, atol=1e-5)).mean())
        sums = abs(img.sum() / ref.sum() - 1.0)
        log(f"golden {name}: values off {off:.4f} (<= 0.01), sum dev {sums:.4f} (<= 0.02)")
        assert off <= 0.01 and sums <= 0.02


@phase("inverse")
def inverse_phase():
    import jax
    import jax.numpy as jnp

    from spectral_tpu.models.scenes import CORNELL, build_scene, scene_camera
    from spectral_tpu.parallel import image_loss, make_mesh, render_image_sharded, train_step, trainable_params

    scene = build_scene(CORNELL)
    cam = scene_camera(CORNELL, 64, 64)
    mesh = make_mesh(1)
    spp, bounces, key = 8, 4, jax.random.PRNGKey(3)
    target = render_image_sharded(scene, cam, key, mesh, spp, bounces) / spp
    # white wall (material 3): constant term of its sigmoid polynomial.
    # The step is small because d/dc0 is ~lambda^2 times d/dc2.
    coeffs0 = trainable_params(scene)["coeffs"].at[3, 2].add(1.0)
    params, losses = {"coeffs": coeffs0}, []
    for _ in range(5):
        params, loss = train_step(params, scene, cam, target, key, mesh, spp, bounces, lr=3e-10)
        losses.append(float(loss))
        assert np.isfinite(np.asarray(params["coeffs"])).all()
    log(f"inverse losses {['%.6f' % v for v in losses]}")
    assert np.isfinite(losses).all() and losses[-1] < 0.5 * losses[0]

    # one compiled value-and-gradient serves the AD and both FD points
    vg = jax.jit(jax.value_and_grad(
        lambda c: image_loss({"coeffs": c}, scene, cam, target, key, mesh, spp, bounces)
    ))
    ad = float(vg(coeffs0)[1][3, 2])
    e = jnp.zeros_like(coeffs0).at[3, 2].set(1.0)
    eps = 1e-3
    fd = (float(vg(coeffs0 + eps * e)[0]) - float(vg(coeffs0 - eps * e)[0])) / (2 * eps)
    log(f"d loss / d c2[white]: AD {ad:.6e} FD {fd:.6e} (rtol 0.05)")
    assert abs(ad) > 0.0 and abs(ad - fd) <= 0.05 * max(abs(ad), abs(fd)) + 1e-7


@phase("four")
def four_phase(size=256, spp=256, bounces=8):
    """The (2, 2) mesh over four cards against one card: the sharded
    render's statistics, where its output and memory live, and one
    sharded inverse-rendering step."""
    import jax

    from spectral_tpu.models.scenes import CORNELL, build_scene, scene_camera
    from spectral_tpu.parallel import make_mesh, render_image_sharded, train_step, trainable_params

    scene = build_scene(CORNELL)
    mesh4, mesh1 = make_mesh(4), make_mesh(1)
    assert dict(mesh4.shape) == {"tile": 2, "sample": 2}, mesh4.shape
    cam = scene_camera(CORNELL, size, size)
    times = {}
    for name, mesh in (("four", mesh4), ("one", mesh1)):
        img = render_image_sharded(scene, cam, jax.random.PRNGKey(1), mesh, spp, bounces)
        img.block_until_ready()  # compiles
        t0 = time.perf_counter()
        img = render_image_sharded(scene, cam, jax.random.PRNGKey(2), mesh, spp, bounces)
        img.block_until_ready()
        times[name] = (time.perf_counter() - t0, img)
    img4, img1 = times["four"][1], times["one"][1]
    devs = img4.sharding.device_set
    # (CPU devices keep no memory stats; the phase runs on cards)
    in_use = [(d.memory_stats() or {}).get("bytes_in_use") for d in jax.devices()[:4]]
    log(f"four-card output spans {len(devs)} devices; bytes_in_use per card {in_use}")
    assert len(devs) == 4
    assert jax.devices()[0].platform == "cpu" or all(b > 0 for b in in_use)
    m4 = float(np.asarray(img4)[..., 1].mean()) / spp
    m1 = float(np.asarray(img1)[..., 1].mean()) / spp
    log(f"{size}x{size}/{spp} spp/{bounces} bounces: mean Y four cards {m4:.5f}, "
        f"one card {m1:.5f} (within 2%); render {times['one'][0]:.3f} s on one card, "
        f"{times['four'][0]:.3f} s on four")
    assert abs(m4 / m1 - 1.0) <= 0.02

    small = scene_camera(CORNELL, 64, 64)
    key = jax.random.PRNGKey(3)
    target = render_image_sharded(scene, small, key, mesh4, 8, 4) / 8
    params = {"coeffs": trainable_params(scene)["coeffs"].at[3, 2].add(1.0)}
    losses = []
    for _ in range(2):
        params, loss = train_step(params, scene, small, target, key, mesh4, 8, 4, lr=3e-10)
        losses.append(float(loss))
    log(f"four-card train_step losses {losses}")
    assert np.isfinite(losses).all() and np.isfinite(np.asarray(params["coeffs"])).all()
    assert losses[1] < losses[0]


def main(argv):
    four = "--four" in argv
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    card = device_phase(4 if four else 1)

    from spectral_tpu.utils.compile_cache import configure_compile_cache

    log(f"compile cache: {configure_compile_cache()}")
    if four:
        four_phase()
    else:
        cli_phase(card)
        scenes_phase()
        field_phase()
        kernel_phase()
        inverse_phase()

    import jax

    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
