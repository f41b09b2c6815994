"""The three hard-coded reference scenes + the Scene pytree.

Scene ids match the reference CLI (io/params.h:15-19): CORNELL=0, PRISM=1,
TRIS=2. Geometry and material tables replicate scene/scene.cu:73-226
construction-for-construction; cameras replicate scene.cu:259-320.

A ``Scene`` is a frozen pytree of SoA device arrays: triangle soup (with the
precomputed edge functionals), the material table, the background SPD,
and the LBVH arrays. It is replicated across the device mesh (resident in
device memory, per BASELINE north star) -- rendering shards pixels, never
the scene.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.rgb2spec import srgb_to_illuminance_spectrum
from ..utils.constants import DENSE_CUTOFF
from .camera import Camera, make_camera
from .geometry import TriSoup, finalize
from .materials import MaterialBuilder, Materials

CORNELL = 0
PRISM = 1
TRIS = 2

SCENE_NAMES = {CORNELL: "cornell", PRISM: "prism", TRIS: "tris"}

# material row of the BK7 dielectric in build_tri_field(glass=True)
# (builder order: white, red, green, metal, light, then the preset)
FIELD_GLASS_MAT = 5


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scene:
    """Device-side scene: triangle SoA + materials + background spectrum."""

    v0: jnp.ndarray  # [T, 3]
    v1: jnp.ndarray
    v2: jnp.ndarray
    normal: jnp.ndarray  # [T, 3] unit
    d: jnp.ndarray  # [T]
    mat_index: jnp.ndarray  # [T] int32
    edge_g: jnp.ndarray  # [T, 3, 3]
    edge_c: jnp.ndarray  # [T, 3]
    bbox_min: jnp.ndarray  # [T, 3]
    bbox_max: jnp.ndarray  # [T, 3]
    materials: Materials
    background_spd: jnp.ndarray  # [95]
    # Optional LBVH (ops/bvh.py). None -> dense intersection (the fast path
    # at reference scene scale); the render entry points attach one above
    # DENSE_CUTOFF triangles (``auto_bvh``).
    bvh: object = None

    @property
    def num_tris(self) -> int:
        return self.v0.shape[0]


def _scene_from(soup: TriSoup, mats: Materials, background_rgb) -> Scene:
    arrs = finalize(soup)
    bg = srgb_to_illuminance_spectrum(jnp.asarray(background_rgb, jnp.float32))
    return Scene(
        v0=jnp.asarray(arrs["v0"]),
        v1=jnp.asarray(arrs["v1"]),
        v2=jnp.asarray(arrs["v2"]),
        normal=jnp.asarray(arrs["normal"]),
        d=jnp.asarray(arrs["d"]),
        mat_index=jnp.asarray(arrs["mat_index"]),
        edge_g=jnp.asarray(arrs["edge_g"]),
        edge_c=jnp.asarray(arrs["edge_c"]),
        bbox_min=jnp.asarray(arrs["bbox_min"]),
        bbox_max=jnp.asarray(arrs["bbox_max"]),
        materials=mats,
        background_spd=bg,
    )


def _cornell_walls(soup: TriSoup, wall_mats: tuple[int, int, int, int, int], light_mat: int):
    """Shared 5-wall + ceiling-light layout (scene.cu:85-107 / 146-168 /
    193-215). wall order: bottom, back, top, left, right."""
    b, bk, t, l, r = wall_mats
    soup.quad((0, 0, 0), (0, 0, 555), (555, 0, 0), b)
    soup.quad((0, 0, 555.0), (0, 555, 0), (555, 0, 0), bk)
    soup.quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), t)
    soup.quad((555, 0, 0), (0, 0, 555), (0, 555, 0), l)
    soup.quad((0, 0, 0), (0, 555, 0), (0, 0, 555), r)
    cx, cy, cz = 555.0 / 2.0, 554.0, 555.0 / 2.0
    w, dep = 100.0, 100.0
    soup.quad((cx + w / 2, cy, cz + dep / 2), (-w, 0, 0), (0, 0, -dep), light_mat)


def _boxes_and_pyramid(soup: TriSoup, box1_mats, box2_mats, pyr_mat: int):
    """box1 + box2 + pyramid block shared by CORNELL and TRIS
    (scene.cu:115-129 / 216-226)."""
    s = len(soup)
    soup.box((0, 0, 0), (165, 330, 165), box1_mats)
    soup.rotate(s, math.radians(25.0), "Y", pivot=soup.slice_bbox_center(s, len(soup)))
    soup.translate(s, (265.0, 0.0, 295.0))

    s = len(soup)
    soup.box((0, 0, 0), (165, 165, 165), box2_mats)
    soup.rotate(s, math.radians(-18.0), "Y", pivot=soup.slice_bbox_center(s, len(soup)))
    soup.translate(s, (130.0, 0.0, 65.0))

    s = len(soup)
    soup.pyramid((165.0, 166.0, 0.0), (-165.0, 0, 0), (0, 0, 165.0), (0, 165.0, 0), pyr_mat)
    # pyramid::rotate pivots on base_center() (pyramid.cu:15-37); the base
    # quad is the first 2 tris of the slice
    soup.rotate(s, math.radians(-18.0), "Y", pivot=soup.slice_vertex_mean(s, s + 2))
    soup.translate(s, (130.0, 0.0, 65.0))


def build_cornell() -> tuple[TriSoup, Materials]:
    """Cornell box, 42 tris / 7 materials (scene.cu:73-130)."""
    mb = MaterialBuilder()
    red = mb.lambertian((0.65, 0.05, 0.05))
    green = mb.lambertian((0.12, 0.45, 0.15))
    glass = mb.dielectric_preset("flint_glass")
    white = mb.lambertian((0.73, 0.73, 0.73))
    light = mb.emissive((1.0, 1.0, 1.0), 5.0)
    metal = mb.metallic((0.5, 0.5, 0.5), 0.3)
    blue = mb.lambertian((0.12, 0.15, 0.45))

    soup = TriSoup()
    _cornell_walls(soup, (white, white, white, green, blue), light)
    _boxes_and_pyramid(soup, metal, red, glass)
    return soup, mb.build()


def build_prism() -> tuple[TriSoup, Materials]:
    """Dispersive prism scene, 20 tris / 3 materials (scene.cu:132-173)."""
    mb = MaterialBuilder()
    white = mb.lambertian((0.73, 0.73, 0.73))
    light = mb.emissive((1.0, 1.0, 1.0), 5.0)
    glass = mb.dielectric_preset("flint_glass")

    soup = TriSoup()
    _cornell_walls(soup, (white, white, white, white, white), light)

    cx, cy, cz = 555.0 / 2.0, 554.0, 555.0 / 2.0
    w = 100.0
    pw, ph = 165.0, 200.0
    s = len(soup)
    soup.prism(
        (cx - w / 2.0, cy - 1.0, cz - ph / 2.0),
        (0.0, -pw, 0.0),
        (pw * math.sqrt(3.0) / 2.0, -pw / 2.0, 0.0),
        (0.0, 0.0, 200.0),
        glass,
    )
    # prism::rotate(local=true) pivots on the mean of the 6 base vertices
    # (prism.cuh:45-56); base tris are the slice's first two
    soup.rotate(s, math.radians(10.0), "Y", pivot=soup.slice_vertex_mean(s, s + 2))
    return soup, mb.build()


def build_tris() -> tuple[TriSoup, Materials]:
    """Mixed-materials scene, 42 tris / 9 materials (scene.cu:175-226)."""
    mb = MaterialBuilder()
    red = mb.lambertian((0.65, 0.05, 0.05))
    green = mb.lambertian((0.12, 0.45, 0.15))
    flint = mb.dielectric_preset("flint_glass")
    white = mb.lambertian((0.73, 0.73, 0.73))
    light = mb.emissive((1.0, 1.0, 1.0), 5.0)
    metal = mb.metallic((0.5, 0.5, 0.5), 0.3)
    blue = mb.lambertian((0.12, 0.15, 0.45))
    bk7 = mb.dielectric_preset("BK7")
    metal2 = mb.metallic((0.7, 0.7, 0.7), 0.8)

    soup = TriSoup()
    _cornell_walls(soup, (blue, green, flint, metal2, metal), light)
    _boxes_and_pyramid(
        soup,
        (white, metal2, red, green, flint, white),
        (bk7, blue, metal2, bk7, green, flint),
        flint,
    )
    return soup, mb.build()


_BUILDERS = {CORNELL: build_cornell, PRISM: build_prism, TRIS: build_tris}


def scene_camera(scene_id: int, image_width: int, image_height: int) -> Camera:
    """All three reference scenes share the same pose (scene.cu:259-320)."""
    return make_camera(
        image_width,
        image_height,
        vfov=40.0,
        lookfrom=(278.0, 278.0, -800.0),
        lookat=(278.0, 278.0, 0.0),
        vup=(0.0, 1.0, 0.0),
        defocus_angle=0.0,
        focus_dist=10.0,
        background=(0.0, 0.0, 0.0),
    )


import functools


@functools.lru_cache(maxsize=None)
def build_scene(scene_id: int) -> Scene:
    soup, mats = _BUILDERS[scene_id]()
    return _scene_from(soup, mats, background_rgb=(0.0, 0.0, 0.0))


def expected_sizes(scene_id: int) -> tuple[int, int]:
    """(num_tris, num_materials) golden counts (scene.cu:228-257)."""
    return {CORNELL: (42, 7), PRISM: (20, 3), TRIS: (42, 9)}[scene_id]


def build_tri_field(
    n_tris: int = 10008, seed: int = 0, glass: bool = False
) -> Scene:
    """Procedural large-scene benchmark: the Cornell shell + ceiling light
    plus a jittered grid of small boxes until >= n_tris triangles.

    The reference has no >42-tri scene, but its BVH exists precisely for
    this scale (bvh/bvh.cu:206-309 builds for arbitrary N); this scene
    exercises the LBVH path at the sizes it was built for. It carries no
    BVH itself: the render entry points attach one (``auto_bvh``).
    Deterministic in ``seed``.

    ``glass``: replace every 4th box with a BK7 dielectric (material row
    ``FIELD_GLASS_MAT``) so large-scene inverse dispersion has a
    BVH-routed target."""
    import numpy as _np

    rng = _np.random.RandomState(seed)
    mb = MaterialBuilder()
    white = mb.lambertian((0.73, 0.73, 0.73))
    red = mb.lambertian((0.65, 0.05, 0.05))
    green = mb.lambertian((0.12, 0.45, 0.15))
    metal = mb.metallic((0.8, 0.85, 0.88), 0.0)
    light = mb.emissive((1.0, 1.0, 1.0), 7.0)

    soup = TriSoup()
    _cornell_walls(soup, (white, white, white, green, red), light)

    box_mats = (white, red, green, metal)
    if glass:
        bk7 = mb.dielectric_preset("BK7")
        assert bk7 == FIELD_GLASS_MAT
        box_mats = (white, bk7, green, metal)
    n_boxes = max(0, -(-(n_tris - len(soup)) // 12))
    grid = int(math.ceil(math.sqrt(n_boxes)))
    cell = 520.0 / grid
    i = 0
    for gz in range(grid):
        for gx in range(grid):
            if i >= n_boxes:
                break
            w = cell * (0.25 + 0.35 * rng.rand())
            h = 10.0 + 120.0 * rng.rand() ** 2
            x = 15.0 + gx * cell + (cell - w) * rng.rand()
            z = 15.0 + gz * cell + (cell - w) * rng.rand()
            s = len(soup)
            soup.box((x, 0.0, z), (x + w, h, z + w), box_mats[i % 4])
            soup.rotate(
                s,
                math.radians(rng.rand() * 90.0),
                "Y",
                pivot=soup.slice_bbox_center(s, len(soup)),
            )
            i += 1
    return _scene_from(soup, mb.build(), background_rgb=(0.0, 0.0, 0.0))


def with_bvh(scene: Scene, leaf_size: int = 8) -> Scene:
    """Attach a Karras LBVH; the renderer then traverses instead of the
    dense sweep (worth it above O(128) triangles — SURVEY section 7.2)."""
    from ..ops.bvh import build_lbvh

    bvh = build_lbvh(scene.bbox_min, scene.bbox_max, leaf_size)
    return dataclasses.replace(scene, bvh=bvh)


def auto_bvh(scene):
    """The one dense-or-BVH rule: a scene above DENSE_CUTOFF triangles that
    carries no BVH gets an LBVH attached; any other scene is returned as
    it is. Dense intersection of a large scene would materialise [N, T]
    candidate tensors (about 21 GB for a 10k-triangle field at 512x256x4
    rays). Works eagerly and under jit (the build is plain jnp)."""
    if getattr(scene, "bvh", None) is None and scene.v0.shape[0] > DENSE_CUTOFF:
        return with_bvh(scene)
    return scene
