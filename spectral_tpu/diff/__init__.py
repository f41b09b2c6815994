from .geometry import derive_tri_arrays, scene_with_vertices

__all__ = [
    "derive_tri_arrays",
    "scene_with_vertices",
]
