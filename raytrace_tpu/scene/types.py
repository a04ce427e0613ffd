"""Compiled scene representation: flat struct-of-arrays device buffers.

The reference represents a scene as a *closure tree* — nested Haskell
functions built at scene-construction time (``Geometry m a``,
Geometry.hs:42).  Here the scene is instead compiled to flat indexed
buffers: one tagged row per primitive, an interned material/texture table,
an optional flat threaded BVH, and a separate buffer for volume-boundary
primitives.  Everything is a pytree, so the whole scene can be donated to
jit, replicated across a device mesh, and differentiated (gradients flow
to primitive params / material colors directly through these leaves).
"""
from __future__ import annotations

import jax.numpy as jnp
from ..core import struct

from ..materials.materials import MaterialTable
from ..textures.textures import TextureTable

# Primitive kinds
PRIM_PAD = -1       # padding row; never hit
PRIM_SPHERE = 0     # p0 = center, e1[0] = radius       (Geometry.hs:58-92)
PRIM_PARALLELOGRAM = 1  # p0 = q, e1 = u, e2 = v        (Geometry.hs:147-151)
PRIM_TRIANGLE = 2   # p0, e1 = p1-p0, e2 = p2-p0, uvs   (Geometry.hs:169-176)
PRIM_BOX = 3        # p0 = lo, e1 = hi: axis-aligned box as ONE slab-test row
#                     (the reference lowers cuboids to 6 parallelograms,
#                     Geometry.hs:154-166; the branchless prim scan
#                     pays per ROW, so an axis-aligned cuboid as a single
#                     slab test is ~6x less scan work — demo2's 400 ground
#                     cuboids are 400 rows instead of 2400).  Rotated /
#                     reflected cuboids still lower to parallelograms at
#                     compile time (scene/compile.py).


class Primitives(struct.PyTreeNode):
    """Tagged primitive rows (SoA).  Transforms are baked into the params at
    compile time (no per-ray inverse transform; see
    scene/compile.py), so rows are always in world space.  ``mv0``/``mv1``
    are motion-blur displacements at time 0 / 1 (Geometry.hs:447-456)."""
    kind: jnp.ndarray   # i32[N]
    p0: jnp.ndarray     # f32[N,3]
    e1: jnp.ndarray     # f32[N,3]
    e2: jnp.ndarray     # f32[N,3]
    uvs: jnp.ndarray    # f32[N,3,2] triangle corner uvs
    mat: jnp.ndarray    # i32[N]
    mv0: jnp.ndarray    # f32[N,3]
    mv1: jnp.ndarray    # f32[N,3]
    n: int = struct.field(pytree_node=False, default=0)          # true count
    has_motion: bool = struct.field(pytree_node=False, default=False)
    # static "any PRIM_BOX rows" flag so scenes without boxes compile
    # zero box code into the (branchless, pays-for-every-kind) prim scans
    has_box: bool = struct.field(pytree_node=False, default=False)
    # static kind segmentation: rows are reordered kind-major (spatial
    # BVH order preserved within each kind, each segment padded to the
    # 64-row cluster width) and this records
    # ``((kind, cluster_start, cluster_end), ...)``.  Segmented tables
    # pad inside each segment, so scans cover the whole table
    # (render/integrator.py:_n_scan_prims).  None = unsegmented (BVH
    # mode / tiny scenes / hand-built Primitives).
    kind_segments: tuple | None = struct.field(pytree_node=False,
                                               default=None)
    # static ``((row, (r00..r22)), ...)`` world->object rotations for the
    # (few) sphere rows baked with a non-identity rotation: sphere UV must
    # be evaluated in OBJECT space (the reference inverse-transforms the
    # ray, Geometry.hs:382-391, so sphereUV at Geometry.hs:100-104 sees
    # object coordinates — a rotated textured sphere shows a rotated
    # texture).  Applied as an unrolled compare+select over winner
    # indices (ops/intersect.py:apply_sphere_rotations) — no gathers.
    sphere_rots: tuple = struct.field(pytree_node=False, default=())

    def __len__(self):
        return self.n


class BVH(struct.PyTreeNode):
    """Flat threaded ("stackless") BVH in depth-first order.

    Traversal needs no stack: on AABB hit, the next node is ``i + 1``
    (first child); on miss — or after processing a leaf — jump to
    ``skip[i]``.  ``skip == n_nodes`` terminates.  Built host-side by
    median split (the algorithm of Geometry.hs:369-377); leaves hold up to
    ``leaf_size`` primitives re-ordered to be contiguous.
    """
    lo: jnp.ndarray     # f32[K,3]
    hi: jnp.ndarray     # f32[K,3]
    start: jnp.ndarray  # i32[K] leaf primitive start (undefined for internal)
    count: jnp.ndarray  # i32[K] leaf primitive count; 0 for internal nodes
    skip: jnp.ndarray   # i32[K] escape pointer
    n_nodes: int = struct.field(pytree_node=False, default=0)


class Volumes(struct.PyTreeNode):
    """Constant-density media (Geometry.hs:298-330).  Each volume owns a
    contiguous slice of ``prims`` (its closed boundary surface);
    ``starts``/``counts`` are static per-volume slice bounds."""
    prims: Primitives
    density: jnp.ndarray   # f32[V]
    mat: jnp.ndarray       # i32[V]
    starts: tuple = struct.field(pytree_node=False, default=())
    counts: tuple = struct.field(pytree_node=False, default=())

    @property
    def n_volumes(self):
        return len(self.starts)


class Ellipsoids(struct.PyTreeNode):
    """Spheres under arbitrary affines (the reference accepts any ``M44``
    with its Euclidean-only normal caveat, Geometry.hs:382-391).  Kept in
    their own small buffer, intersected in object space and merged after
    the main primitive scan (render/integrator.py:_surface_hit) — scenes
    without them pay nothing.

    ``center``/``radius`` are object-space; ``fwd``/``inv`` the linear
    part A / A^-1; ``shift`` the translation; normals are transformed by
    A (matching the reference's behavior, then normalized) and UV is
    evaluated in object space."""
    center: jnp.ndarray   # f32[E,3]
    radius: jnp.ndarray   # f32[E]
    fwd: jnp.ndarray      # f32[E,3,3]
    inv: jnp.ndarray      # f32[E,3,3]
    shift: jnp.ndarray    # f32[E,3]
    mat: jnp.ndarray      # i32[E]
    mv0: jnp.ndarray      # f32[E,3] world-space motion displacement @ t=0
    mv1: jnp.ndarray      # f32[E,3]
    n: int = struct.field(pytree_node=False, default=0)
    has_motion: bool = struct.field(pytree_node=False, default=False)


class Scene(struct.PyTreeNode):
    prims: Primitives
    materials: MaterialTable
    textures: TextureTable
    bvh: BVH | None = None
    volumes: Volumes | None = None
    ellipsoids: Ellipsoids | None = None
