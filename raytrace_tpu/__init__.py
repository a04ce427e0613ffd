"""raytrace_tpu — a differentiable path tracer in JAX.

Built from scratch in JAX/XLA with the full capability surface of
the Haskell reference library (see SURVEY.md): primitives, meshes, BVH,
volumes, ten materials, procedural + image textures, motion blur, thin-lens
defocus, and importance-sampled light redirection with MIS — re-designed
as a wavefront renderer over struct-of-arrays scene buffers.
"""
from .core.vecmath import degrees
from .materials.materials import (
    anisotropic, dielectric, isotropic, lambertian, light_source,
    lommel_seeliger, metal, mirror, pitch_black, transparent,
)
from .render.camera import (
    CameraSettings, const_background, gray_fade, sky,
)
from .render.image import read_image, write_image, write_image_sqrt
from .render.render import render
from .scene.builder import (
    Mesh, bvh_tree, compose, constant_medium, cuboid, cuboids, group,
    moving, parallelogram, rotate_x, rotate_y, rotate_z, scale, sphere,
    spheres, transform, translate, triangle, triangle_mesh, with_material,
)
from .scene.compile import compile_scene
from .scene.obj import parse_obj, read_obj
from .textures.textures import (
    checker_texture, constant_texture, custom_texture, image_texture,
    marble_texture, noise_texture, solid_texture, uv_texture,
)

__version__ = "0.1.0"
