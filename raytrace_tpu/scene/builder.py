"""User-facing scene construction API.

Mirrors the reference's constructor surface (Geometry.hs) — ``sphere``,
``parallelogram``, ``triangle``, ``cuboid``, ``triangle_mesh``,
``constant_medium``, ``group``, ``transform``, ``moving`` plus the matrix
builders ``translate``/``rotate_x/y/z``/``scale`` — but builds a lightweight
Python node tree that :func:`raytrace_tpu.scene.compile.compile_scene`
flattens into device buffers.  Materials are attached with
``with_material(mat, geom)`` (the reference's ``mat <$ geom``,
Geometry.hs:44-47); like the Haskell functor, the *outermost* attachment
wins for every leaf below it.

Batch constructors (``spheres``, ``cuboids``) exist because a scene
with 400 procedural spheres should be one vectorized row-block, not 400
Python objects.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np

from ..materials.materials import Material
from .types import PRIM_BOX, PRIM_PARALLELOGRAM, PRIM_SPHERE, PRIM_TRIANGLE

__all__ = [
    "Geom", "sphere", "spheres", "parallelogram", "triangle", "cuboid",
    "cuboids", "group", "transform", "moving", "constant_medium",
    "with_material", "triangle_mesh", "Mesh", "translate", "rotate_x",
    "rotate_y", "rotate_z", "scale", "compose",
]


class Geom:
    """Base class for scene-graph nodes."""


@dataclasses.dataclass
class PrimBlock(Geom):
    """A batch of primitives of one kind (SoA numpy rows)."""
    kind: int
    p0: np.ndarray          # [n,3]
    e1: np.ndarray          # [n,3]
    e2: np.ndarray          # [n,3]
    uvs: np.ndarray | None  # [n,3,2] or None


@dataclasses.dataclass
class Group(Geom):
    children: list


@dataclasses.dataclass
class Transform(Geom):
    matrix: np.ndarray      # 4x4 affine, bottom row 0 0 0 1
    child: Geom


@dataclasses.dataclass
class Moving(Geom):
    v0: np.ndarray
    v1: np.ndarray
    child: Geom


@dataclasses.dataclass
class Medium(Geom):
    density: float
    child: Geom


@dataclasses.dataclass
class WithMaterial(Geom):
    material: Material
    child: Geom


def _v3(x) -> np.ndarray:
    a = np.asarray(x, np.float64)
    if a.ndim == 0:
        a = np.full(3, float(a))
    return a.reshape(3)


# ---------------------------------------------------------------------------
# Primitive constructors
# ---------------------------------------------------------------------------

def sphere(center, radius: float) -> Geom:
    """Sphere from center and radius (Geometry.hs:58-92)."""
    return spheres(_v3(center)[None], np.asarray([radius], np.float64))


def spheres(centers, radii) -> Geom:
    """Batch of spheres: centers [n,3], radii [n]."""
    centers = np.asarray(centers, np.float64).reshape(-1, 3)
    radii = np.asarray(radii, np.float64).reshape(-1)
    e1 = np.zeros_like(centers)
    e1[:, 0] = radii
    return PrimBlock(PRIM_SPHERE, centers, e1, np.zeros_like(centers), None)


def parallelogram(q, u, v) -> Geom:
    """Parallelogram from corner + two edges (Geometry.hs:147-151).
    Front side by the right-hand rule (normal along cross(u, v))."""
    return PrimBlock(
        PRIM_PARALLELOGRAM, _v3(q)[None], _v3(u)[None], _v3(v)[None], None
    )


def triangle(p0, p1, p2, uv0=(0.0, 0.0), uv1=(1.0, 0.0), uv2=(0.0, 1.0)) -> Geom:
    """Triangle from three corners and their texture coordinates
    (Geometry.hs:169-176; default uvs per triangleMesh, Geometry.hs:288-294)."""
    p0, p1, p2 = _v3(p0), _v3(p1), _v3(p2)
    uvs = np.asarray([uv0, uv1, uv2], np.float64)[None]
    return PrimBlock(PRIM_TRIANGLE, p0[None], (p1 - p0)[None], (p2 - p0)[None], uvs)


def cuboid(corner0, corner1) -> Geom:
    """Axis-aligned box (Geometry.hs:154-166).  Kept as ONE slab-test
    primitive row; lowered to the reference's six parallelograms at
    compile time only if a non-axis-aligned transform is applied."""
    return cuboids(_v3(corner0)[None], _v3(corner1)[None])


def cuboids(corners0, corners1) -> Geom:
    """Batch of axis-aligned boxes: two [n,3] opposite-corner arrays."""
    c0 = np.asarray(corners0, np.float64).reshape(-1, 3)
    c1 = np.asarray(corners1, np.float64).reshape(-1, 3)
    lo = np.minimum(c0, c1)
    hi = np.maximum(c0, c1)
    return PrimBlock(PRIM_BOX, lo, hi, np.zeros_like(lo), None)


def box_faces(lo: np.ndarray, hi: np.ndarray) -> "PrimBlock":
    """Lower axis-aligned boxes [n,3],[n,3] to the reference's six
    parallelograms with outward winding (Geometry.hs:154-166) — used when
    a rotation/reflection is baked in and the slab form can't survive."""
    n = lo.shape[0]
    dx = np.zeros((n, 3)); dx[:, 0] = hi[:, 0] - lo[:, 0]
    dy = np.zeros((n, 3)); dy[:, 1] = hi[:, 1] - lo[:, 1]
    dz = np.zeros((n, 3)); dz[:, 2] = hi[:, 2] - lo[:, 2]
    xmin_ymin_zmax = lo + dz
    xmax_ymin_zmin = lo + dx
    xmin_ymax_zmax = lo + dy + dz
    # Same six faces / windings as Geometry.hs:154-166.
    qs = np.concatenate([
        xmin_ymin_zmax,        # front
        xmax_ymin_zmin,        # back
        lo,                    # left
        lo + dx + dz,          # right
        xmin_ymax_zmax,        # top
        lo,                    # bottom
    ])
    us = np.concatenate([dx, -dx, dz, -dz, dx, dx])
    vs = np.concatenate([dy, dy, dy, dy, -dz, dz])
    return PrimBlock(PRIM_PARALLELOGRAM, qs, us, vs, None)


# ---------------------------------------------------------------------------
# Aggregation / wrappers
# ---------------------------------------------------------------------------

def group(children: Sequence[Geom]) -> Geom:
    """Group objects (Geometry.hs:336-347).  Acceleration structure choice
    happens at compile time, so ``group`` and the reference's ``bvhTree``
    are the same node here."""
    return Group(list(children))


bvh_tree = group


def transform(matrix, geom: Geom) -> Geom:
    """Apply a 4x4 affine transform (Geometry.hs:382-391).  Unlike the
    reference (which inverse-transforms every ray at hit time), the
    transform is *baked into primitive parameters* at compile time —
    and as a consequence arbitrary affines are supported for planar
    primitives, and rotation+translation+uniform-scale for spheres."""
    return Transform(np.asarray(matrix, np.float64).reshape(4, 4), geom)


def moving(v0, v1, geom: Geom) -> Geom:
    """Motion blur: translated by v0 at time 0 and v1 at time 1
    (Geometry.hs:447-456)."""
    return Moving(_v3(v0), _v3(v1), geom)


def constant_medium(density: float, geom: Geom) -> Geom:
    """Constant-density participating medium bounded by a closed surface
    (Geometry.hs:298-330).  Attach ``isotropic``/``anisotropic``/
    ``pitch_black`` materials with :func:`with_material`."""
    return Medium(float(density), geom)


def with_material(material: Material, geom: Geom) -> Geom:
    """Attach a material to every primitive below (``<$``, Geometry.hs:44-47);
    outermost attachment wins, as in the reference functor."""
    return WithMaterial(material, geom)


# ---------------------------------------------------------------------------
# Matrix builders (Geometry.hs:393-445)
# ---------------------------------------------------------------------------

def translate(v) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = _v3(v)
    return m


def _rot(axis: int, angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    m = np.eye(4)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    m[i, i] = c; m[i, j] = -s
    m[j, i] = s; m[j, j] = c
    return m


def rotate_x(angle: float) -> np.ndarray:
    return _rot(0, angle)


def rotate_y(angle: float) -> np.ndarray:
    # Geometry.hs:415-423: [[c,0,s],[0,1,0],[-s,0,c]]
    c, s = math.cos(angle), math.sin(angle)
    m = np.eye(4)
    m[0, 0] = c; m[0, 2] = s
    m[2, 0] = -s; m[2, 2] = c
    return m


def rotate_z(angle: float) -> np.ndarray:
    return _rot(2, angle)


def scale(a: float) -> np.ndarray:
    m = np.eye(4) * float(a)
    m[3, 3] = 1.0
    return m


def compose(*matrices) -> np.ndarray:
    """Right-to-left matrix composition (Haskell's ``!*!`` chain)."""
    out = np.eye(4)
    for m in matrices:
        out = out @ np.asarray(m, np.float64).reshape(4, 4)
    return out


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Mesh:
    """Indexed triangle mesh (Geometry.hs:179-184): vertex positions [V,3],
    texture coords [T,2], faces [F,3] vertex indices, uv_faces [F,3]
    indices into ``uv`` or -1 for the default corner uvs."""
    vertices: np.ndarray
    uv: np.ndarray
    faces: np.ndarray
    uv_faces: np.ndarray

    def transform_vertices(self, matrix) -> "Mesh":
        """Affine-transform all vertices (Geometry.hs:187-190)."""
        m = np.asarray(matrix, np.float64).reshape(4, 4)
        v = self.vertices @ m[:3, :3].T + m[:3, 3]
        return dataclasses.replace(self, vertices=v)

    def bounding_box(self):
        return self.vertices.min(0), self.vertices.max(0)


def triangle_mesh(mesh: Mesh) -> Geom:
    """Realize a mesh as a batch of triangle primitives (Geometry.hs:288-294).
    Missing uv indices default to (0,0)/(1,0)/(0,1)."""
    verts = np.asarray(mesh.vertices, np.float64)
    faces = np.asarray(mesh.faces, np.int64)
    p = verts[faces]                      # [F,3,3]
    default_uvs = np.asarray([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    uvf = np.asarray(mesh.uv_faces, np.int64)
    if mesh.uv.size:
        uvs = np.where(
            (uvf >= 0)[..., None],
            np.asarray(mesh.uv, np.float64)[np.clip(uvf, 0, None)],
            default_uvs[None],
        )
    else:
        uvs = np.broadcast_to(default_uvs[None], (faces.shape[0], 3, 2)).copy()
    return PrimBlock(
        PRIM_TRIANGLE, p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], uvs
    )
