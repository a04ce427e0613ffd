"""Material system: builder-side descriptors + a flat, jit-friendly table.

The reference material model (Material.hs:17-34) is a closure
``inDir -> HitRecord -> (emitted, random MaterialResult)`` with a 4-way
result: Absorb / Scatter color dir / HemisphereF brdf / SphereF phase.  The
4-way split is the contract that lets the *integrator* own importance
sampling (redirection/MIS, Ray.hs:187-224).

Array re-design: materials are integer-tagged rows in a struct-of-arrays
table.  The integrator classifies each lane by tag into the same four
behaviour classes and evaluates everything branchlessly (masked selects).
The ten reference materials (Material.hs:41-129) map to ten tags.
"""
from __future__ import annotations

import dataclasses

from ..textures.textures import Texture, constant_texture

import numpy as np
import jax.numpy as jnp
from ..core import struct

# Material kinds (tags)
MAT_LIGHT = 0          # emit texture color, absorb (Material.hs:42-44)
MAT_PITCH_BLACK = 1    # emit zero, absorb (Material.hs:46-49)
MAT_LAMBERTIAN = 2     # HemisphereF const tex (Material.hs:51-55)
MAT_LOMMEL = 3         # HemisphereF 0.25/(mu0+mu1) * tex (Material.hs:57-63)
MAT_MIRROR = 4         # Scatter tex (reflect) (Material.hs:65-69)
MAT_METAL = 5          # fuzzy reflect, absorb below horizon (Material.hs:71-78)
MAT_DIELECTRIC = 6     # Schlick reflect/refract (Material.hs:87-106)
MAT_TRANSPARENT = 7    # Scatter tex (same dir) (Material.hs:108-112)
MAT_ISOTROPIC = 8      # SphereF const tex (Material.hs:114-118)
MAT_ANISOTROPIC = 9    # SphereF Henyey-Greenstein (Material.hs:120-129)

# Behaviour classes derived from tags
_ABSORB_KINDS = (MAT_LIGHT, MAT_PITCH_BLACK)
_SCATTER_KINDS = (MAT_MIRROR, MAT_METAL, MAT_DIELECTRIC, MAT_TRANSPARENT)
_HEMI_KINDS = (MAT_LAMBERTIAN, MAT_LOMMEL)
_SPHERE_KINDS = (MAT_ISOTROPIC, MAT_ANISOTROPIC)


@dataclasses.dataclass(frozen=True)
class Material:
    kind: int
    texture: Texture | None = None
    param: float = 0.0   # fuzz (metal) / ior (dielectric) / g (anisotropic)

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


def light_source(texture: Texture) -> Material:
    return Material(MAT_LIGHT, texture)


def pitch_black() -> Material:
    return Material(MAT_PITCH_BLACK, constant_texture(0.0))


def lambertian(texture: Texture) -> Material:
    return Material(MAT_LAMBERTIAN, texture)


def lommel_seeliger(texture: Texture) -> Material:
    return Material(MAT_LOMMEL, texture)


def mirror(texture: Texture) -> Material:
    return Material(MAT_MIRROR, texture)


def metal(fuzz: float, texture: Texture) -> Material:
    return Material(MAT_METAL, texture, float(fuzz))


def dielectric(ior: float) -> Material:
    return Material(MAT_DIELECTRIC, constant_texture(1.0), float(ior))


def transparent(texture: Texture) -> Material:
    return Material(MAT_TRANSPARENT, texture)


def isotropic(texture: Texture) -> Material:
    return Material(MAT_ISOTROPIC, texture)


def anisotropic(g: float, texture: Texture) -> Material:
    return Material(MAT_ANISOTROPIC, texture, float(g))


class MaterialTable(struct.PyTreeNode):
    """Interned materials: one row per distinct Material descriptor."""
    kind: jnp.ndarray   # i32[M]
    tex: jnp.ndarray    # i32[M] texture id
    param: jnp.ndarray  # f32[M]
    kinds_present: tuple = struct.field(pytree_node=False, default=())


def compile_materials(materials, texture_index) -> MaterialTable:
    """Intern a list of Material descriptors; ``texture_index`` maps
    Texture descriptor -> texture id."""
    n = max(len(materials), 1)
    kind = np.zeros(n, np.int32)
    tex = np.zeros(n, np.int32)
    param = np.zeros(n, np.float32)
    for i, m in enumerate(materials):
        kind[i] = m.kind
        tex[i] = texture_index[m.texture]
        param[i] = m.param
    present = tuple(sorted(set(int(k) for k in kind[: len(materials)])))

    return MaterialTable(
        kind=jnp.asarray(kind), tex=jnp.asarray(tex), param=jnp.asarray(param),
        kinds_present=present,
    )
