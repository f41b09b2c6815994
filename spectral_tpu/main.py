"""CLI entry point — parity with the reference's main.cpp.

Reference flow (main.cpp:135-167): parse args -> init device constants ->
scene -> render loop (progressive display) -> save/log. Device-constant
upload is implicit here (tables are jnp arrays captured by jit), display is
a progressive PNG preview (the CImg window main.cpp:20-40 maps to an
in-terminal view plus a refreshing preview file), save writes a BMP under
``renders/`` exactly like io/save_image.cpp.

Usage: python -m spectral_tpu.main -s 0 -xr 600 -ns 500 -bl 10 --save --no-show
"""

from __future__ import annotations

import sys
import time

import jax

from .config import parse_args
from .io.image import save_image, save_render
from .models.scenes import SCENE_NAMES, build_scene, scene_camera
from .runtime.render_manager import RenderManager
from .utils.compile_cache import configure_compile_cache
from .utils.logging import reset_log_context
from .render.wavefront import xyz_to_image


def main(argv: list[str] | None = None) -> int:
    p = parse_args(sys.argv[1:] if argv is None else argv)
    configure_compile_cache()
    log = reset_log_context(p.title, p.log_subdir)

    log.add_entry("title", p.title)
    log.add_entry("scene", SCENE_NAMES.get(p.scene, str(p.scene)))

    t0 = time.perf_counter()
    scene = build_scene(p.scene)
    cam = scene_camera(p.scene, p.xres, p.yres)
    log.add_entry("scene build time (seconds)", time.perf_counter() - t0)
    log.add_entry("triangles", scene.num_tris)

    rm = RenderManager(scene, cam, p, log)

    preview_path = f"renders/{p.title}_preview.png"
    done = [0]
    total = sum(1 for _ in rm.chunks())

    display = None
    if p.show:
        from .io.display import TerminalDisplay

        display = TerminalDisplay(p.xres, p.yres)

    def on_chunk(c, fb_xyz):
        done[0] += 1
        print(
            f"\rchunk {done[0]}/{total} "
            f"({c.x0},{c.y0} {c.width}x{c.height})",
            end="",
            file=sys.stderr,
            flush=True,
        )
        if p.show:  # progressive live view (the CImg window analogue):
            # in-terminal truecolor rendering when stdout is a tty, plus a
            # refreshing PNG preview either way
            import numpy as np

            img = np.asarray(xyz_to_image(jax.numpy.asarray(fb_xyz), p.nsamples))
            if display is not None:
                display.update(img)
            save_image(img, preview_path)

    if p.profile_dir:
        # profiler bracket around the render loop (main.cpp:28,57 analogue)
        jax.profiler.start_trace(p.profile_dir)
    try:
        img = rm.render(jax.random.PRNGKey(1984), on_chunk)
    finally:
        if p.profile_dir:
            jax.profiler.stop_trace()
            print(f"profiler trace in {p.profile_dir}", file=sys.stderr)
    print("", file=sys.stderr)

    if p.save:
        path = save_render(img, p.title)
        print(f"saved {path}")
    if p.show:
        print(f"preview at {preview_path}")
    if p.do_log:
        path = log.to_file()
        print(f"log at {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
