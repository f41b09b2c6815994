"""Host-side render orchestration: the chunked progressive render loop.

The JAX form of the reference's render_manager
(rendering/render_manager.cu:3-66 ``step``, render_manager.cuh:68-181
producer/consumer double buffer): JAX dispatch is already asynchronous, so
the explicit worker thread + binary semaphores become "launch chunk k+1
before blocking on chunk k's host transfer" — the same overlap of device
compute with host consumption, with XLA's stream machinery playing the role
of the CUDA default stream + cudaMemcpyAsync.

The de-swizzle step (render_manager.cuh:88-136, block-ordered device output
back to row-major) does not exist here: chunks are row-major by
construction.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator

import jax
import numpy as np

from ..config import RenderParams
from ..models.camera import Camera
from ..models.scenes import auto_bvh
from ..render.wavefront import render_chunk, xyz_to_image
from ..utils.constants import DENSE_CUTOFF
from ..utils.logging import LogContext
from ..utils.prng import fold


def select_impl(impl: str, n_tris: int, platform: str | None = None) -> str:
    """The compute path for a render: "pallas" (the megakernel) or "xla"
    (the wavefront reference).

    ``auto`` takes the megakernel on a GPU for dense scenes (at most
    DENSE_CUTOFF triangles) and the XLA wavefront everywhere else. An
    explicit ``pallas`` that the platform or scene cannot run raises; it
    never falls back to interpret mode or to XLA."""
    platform = platform or jax.default_backend()
    if impl == "xla":
        return "xla"
    if impl == "pallas":
        if platform != "gpu":
            raise ValueError(
                f"--impl pallas needs a GPU; this backend is {platform!r}"
            )
        if n_tris > DENSE_CUTOFF:
            raise ValueError(
                f"--impl pallas: {n_tris} triangles > DENSE_CUTOFF="
                f"{DENSE_CUTOFF}; the megakernel is dense-only"
            )
        return "pallas"
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}")
    return "pallas" if platform == "gpu" and n_tris <= DENSE_CUTOFF else "xla"


@dataclass
class ChunkResult:
    x0: int
    y0: int
    width: int
    height: int
    xyz: jax.Array  # accumulated XYZ [h, w, 3] (device)


@dataclass
class RenderManager:
    """Owns the chunk grid and the progressive accumulation buffer."""

    scene: object
    cam: Camera
    params: RenderParams
    log: LogContext | None = None
    _fb_xyz: np.ndarray = field(init=False)

    def __post_init__(self):
        self._fb_xyz = np.zeros(
            (self.cam.image_height, self.cam.image_width, 3), np.float32
        )
        self.impl = select_impl(self.params.impl, self.scene.num_tris)
        # build the LBVH of a large scene once, not once per chunk
        self.scene = auto_bvh(self.scene)

    def chunks(self) -> Iterator[tuple[int, int, int, int]]:
        """Row-major chunk grid (render_manager.cu:56-64 offset advance).
        Edge chunks are clamped to the image, not skipped."""
        cw, ch = self.params.chunk_width, self.params.chunk_height
        w, h = self.cam.image_width, self.cam.image_height
        for y0 in range(0, h, ch):
            for x0 in range(0, w, cw):
                yield x0, y0, min(cw, w - x0), min(ch, h - y0)

    def render(
        self,
        key: jax.Array,
        on_chunk: Callable[[ChunkResult, np.ndarray], None] | None = None,
        checkpoint: str | None = None,
    ) -> np.ndarray:
        """Render all chunks with a 2-deep launch pipeline; returns the
        uint8 sRGB image. ``on_chunk`` receives each finished chunk plus the
        full-frame XYZ accumulator (the progressive-display hook,
        main.cpp:33-41).

        ``checkpoint``: path to a .npz tile checkpoint. Completed chunks
        are persisted after each consume and skipped on restart — chunk
        renders are pure functions of (scene, camera, chunk, key), so
        resume is exact (SURVEY section 5: the reference loses everything
        on interruption; here a partial render survives the process).
        """
        p = self.params
        t0 = time.perf_counter()

        done: set[tuple[int, int]] = set()
        if checkpoint and os.path.exists(checkpoint):
            z = np.load(checkpoint)
            self._fb_xyz = z["fb_xyz"]
            done = {(int(a), int(b)) for a, b in z["done"]}

        def save_ckpt():
            if checkpoint:
                tmp = checkpoint + ".tmp.npz"
                np.savez(
                    tmp,
                    fb_xyz=self._fb_xyz,
                    done=np.asarray(sorted(done), np.int64).reshape(-1, 2),
                )
                os.replace(tmp, checkpoint)

        launched: list[ChunkResult] = []
        # the kernel hashes one seed per render with each pixel's
        # coordinates; drawn before the first launch, so this host read
        # never waits behind an in-flight chunk
        seed = (
            int(jax.random.randint(key, (), 0, 2**31 - 1))
            if self.impl == "pallas"
            else 0
        )

        def launch(x0, y0, w, h) -> ChunkResult:
            if self.impl == "pallas":
                from ..ops.pallas.render_kernel import render_chunk_pallas

                xyz = render_chunk_pallas(
                    self.scene, self.cam, seed, x0, y0, w, h,
                    p.nsamples, p.bounce_limit,
                )
            else:
                xyz = render_chunk(
                    self.scene, self.cam, fold(key, y0 * self.cam.image_width + x0),
                    x0, y0, w, h, p.nsamples, p.bounce_limit,
                )
            return ChunkResult(x0, y0, w, h, xyz)

        grid = [c for c in self.chunks() if (c[0], c[1]) not in done]
        # double-buffer: keep one chunk in flight ahead of the consumer
        for i, spec in enumerate(grid):
            launched.append(launch(*spec))
            if len(launched) >= 2 or i == len(grid) - 1:
                c = launched.pop(0)
                self._consume(c, on_chunk)
                done.add((c.x0, c.y0))
                save_ckpt()
        while launched:
            c = launched.pop(0)
            self._consume(c, on_chunk)
            done.add((c.x0, c.y0))
            save_ckpt()

        dt = time.perf_counter() - t0
        if self.log is not None:
            self.log.add_entry("total rendering time (seconds)", dt)
            self.log.add_entry("compute path", self.impl)
            self.log.add_entry(
                "non-finite values", int(np.count_nonzero(~np.isfinite(self._fb_xyz)))
            )
            self.log.add_entry("chunks", len(grid))
            self.log.add_entry("samples per pixel", p.nsamples)
            self.log.add_entry("bounce limit", p.bounce_limit)
            self.log.add_entry(
                "resolution", f"{self.cam.image_width}x{self.cam.image_height}"
            )
        return self.image()

    def _consume(self, c: ChunkResult, on_chunk) -> None:
        xyz = np.asarray(c.xyz)  # blocks on this chunk only
        self._fb_xyz[c.y0 : c.y0 + c.height, c.x0 : c.x0 + c.width] = xyz
        if on_chunk is not None:
            on_chunk(c, self._fb_xyz)

    @property
    def xyz(self) -> np.ndarray:
        """The accumulated XYZ framebuffer [H, W, 3] (sum over samples)."""
        return self._fb_xyz

    def image(self) -> np.ndarray:
        """Current framebuffer as uint8 sRGB (save_to_fb + image_channels).
        Uses the native multithreaded converter when built (bit-identical
        to the jnp path; see tests/test_native.py)."""
        from . import native

        out = native.xyz_to_srgb_u8(self._fb_xyz, self.params.nsamples)
        if out is not None:
            return out
        return np.asarray(
            xyz_to_image(jax.numpy.asarray(self._fb_xyz), self.params.nsamples)
        )
