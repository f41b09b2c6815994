"""CLI / config system with flag parity to the reference's param_manager.

Reference: io/params.h — singleton flag parser + typed parameter store.
Flags (params.h:240-303) and defaults (params.h:204-222) are replicated
one-for-one, including the derived values: yres from xres/aspect-ratio
(params.h:176-180) and the chunk-size fallback chain xc -> yc -> full
resolution (params.h:53-63). Like the reference, a malformed flag value is
tolerated and the default kept (params.h:93-161).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

CORNELL = 0
PRISM = 1
TRIS = 2


@dataclasses.dataclass
class RenderParams:
    """Typed parameter store (reference ``parameters``, params.h:21-82)."""

    title: str = "render"
    log_subdir: str = ""
    scene: int = CORNELL
    xres: int = 600
    aspect_ratio: float = 1.0
    xcsize: int = -1  # chunk width; -1 = unset
    ycsize: int = -1  # chunk height; -1 = unset
    nsamples: int = 500
    bounce_limit: int = 10
    do_log: bool = False
    show: bool = True
    save: bool = False
    # extension beyond the reference CLI: compute path selection
    # (runtime/render_manager.py::select_impl). auto = the Pallas
    # megakernel on a GPU for dense scenes, the XLA wavefront otherwise.
    impl: str = "auto"
    # profiler trace output dir (the reference brackets its render loop with
    # cudaProfilerStart/Stop for Nsight, main.cpp:9,28,57; here it is a
    # jax.profiler trace). Empty = off.
    profile_dir: str = ""

    @property
    def yres(self) -> int:
        """Derived height, min 1 (params.h:176-180)."""
        return max(1, int(self.xres / self.aspect_ratio))

    @property
    def chunk_width(self) -> int:
        """Fallback chain xc -> yc -> xres (params.h:53-63)."""
        if self.xcsize > 0:
            return min(self.xcsize, self.xres)
        if self.ycsize > 0:
            return min(self.ycsize, self.xres)
        return self.xres

    @property
    def chunk_height(self) -> int:
        if self.ycsize > 0:
            return min(self.ycsize, self.yres)
        if self.xcsize > 0:
            return min(self.xcsize, self.yres)
        return self.yres


def _parse(value: str, cast, default):
    """Per-flag parse-error tolerance: keep the default (params.h:93-161)."""
    try:
        return cast(value)
    except (TypeError, ValueError):
        return default


def parse_args(argv: Sequence[str]) -> RenderParams:
    """Parse a reference-compatible argv (no program name) into params.

    Flags (params.h:240-303): -t/--title, -lsub/--log-subdir, -s/--scene,
    -xr/--xres, -ar/--aspect-ratio, -xc/--xcsize, -yc/--ycsize,
    -ns/--nsamples, -bl/--bounce-limit, --do-log, --no-show, --save.
    Unknown flags are ignored, as in the reference's argv loop.
    """
    p = RenderParams()
    i = 0
    n = len(argv)

    def val() -> str | None:
        return argv[i + 1] if i + 1 < n else None

    while i < n:
        a = argv[i]
        if a in ("-t", "--title") and val() is not None:
            p.title = val()
            i += 1
        elif a in ("-lsub", "--log-subdir") and val() is not None:
            p.log_subdir = val()
            i += 1
        elif a in ("-s", "--scene") and val() is not None:
            p.scene = _parse(val(), int, p.scene)
            if p.scene not in (CORNELL, PRISM, TRIS):
                p.scene = CORNELL
            i += 1
        elif a in ("-xr", "--xres") and val() is not None:
            p.xres = _parse(val(), int, p.xres)
            i += 1
        elif a in ("-ar", "--aspect-ratio") and val() is not None:
            p.aspect_ratio = _parse(val(), float, p.aspect_ratio)
            i += 1
        elif a in ("-xc", "--xcsize") and val() is not None:
            p.xcsize = _parse(val(), int, p.xcsize)
            i += 1
        elif a in ("-yc", "--ycsize") and val() is not None:
            p.ycsize = _parse(val(), int, p.ycsize)
            i += 1
        elif a in ("-ns", "--nsamples") and val() is not None:
            p.nsamples = _parse(val(), int, p.nsamples)
            i += 1
        elif a in ("-bl", "--bounce-limit") and val() is not None:
            p.bounce_limit = _parse(val(), int, p.bounce_limit)
            i += 1
        elif a == "--impl" and val() is not None:
            if val() in ("auto", "pallas", "xla"):
                p.impl = val()
            i += 1
        elif a == "--profile" and val() is not None:
            p.profile_dir = val()
            i += 1
        elif a == "--do-log":
            p.do_log = True
        elif a == "--no-show":
            p.show = False
        elif a == "--save":
            p.save = True
        i += 1
    return p
