"""Scene compiler: Python scene graph -> flat device buffers.

This replaces the reference's scene-construction-time closure nesting
(Geometry.hs builds a tree of Haskell functions) with an explicit compile
step, the array design from SURVEY.md §7:

* **Transforms are baked** into primitive parameters (world space), so the
  hot loop never inverse-transforms rays (reference does so per hit test,
  Geometry.hs:388-391).  Planar primitives support arbitrary affines
  (q, u, v transform covariantly and the normal is recomputed from the new
  edges — more general than the reference's Euclidean-only warning);
  spheres support rotation + translation + uniform scale.
* **Motion** (Geometry.hs:447-456) becomes two per-primitive world-space
  displacement vectors, applied to ray origins in-kernel.
* **Materials and textures are interned** into flat tables.
* **Media** (Geometry.hs:298-330) get their own boundary-primitive buffer
  with static per-volume slice bounds.
* A threaded **BVH** (scene/bvh.py) is built host-side when the scene is
  big enough to warrant it; smaller scenes use dense all-primitive
  intersection.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from ..materials.materials import Material, compile_materials
from ..textures.textures import Texture, compile_textures
from . import builder as B
from .bvh import build_bvh, prim_aabbs
from .types import (
    BVH, PRIM_BOX, PRIM_PAD, PRIM_PARALLELOGRAM, PRIM_SPHERE, PRIM_TRIANGLE,
    Primitives, Scene, Volumes,
)

_DEFAULT_TRI_UVS = np.asarray([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])


_EYE9 = np.eye(3).ravel()


@dataclasses.dataclass
class _Rows:
    kind: list
    p0: list
    e1: list
    e2: list
    uvs: list
    mat: list
    mv0: list
    mv1: list
    rot: list  # [n, 9] world->object rotation (sphere UV; identity else)

    @classmethod
    def empty(cls):
        return cls([], [], [], [], [], [], [], [], [])

    def n(self):
        return sum(k.shape[0] for k in self.kind)


class _Interner:
    def __init__(self):
        self.textures: dict[Texture, int] = {}
        self.materials: dict[Material, int] = {}

    def material_id(self, m: Material) -> int:
        if m not in self.materials:
            if m.texture not in self.textures:
                self.textures[m.texture] = len(self.textures)
            self.materials[m] = len(self.materials)
        return self.materials[m]


def _bake_block(block: B.PrimBlock, matrix: np.ndarray, mv0, mv1, mat_id: int,
                rows: _Rows, ellipsoids: list | None = None):
    a = matrix[:3, :3]
    b = matrix[:3, 3]
    n = block.p0.shape[0]
    kind = np.full(n, block.kind, np.int32)
    if block.kind == PRIM_BOX:
        # A box row survives only transforms that map axis-aligned boxes
        # to axis-aligned boxes WITH the same face->uv orientation, i.e.
        # positive uniform scale + translation.  Anything else (rotation,
        # reflection, non-uniform scale) lowers to the reference's six
        # parallelograms (Geometry.hs:154-166) and re-bakes.
        s = a[0, 0]
        if s > 0.0 and np.allclose(a, s * np.eye(3),
                                   atol=1e-12 * max(abs(s), 1.0)):
            rows.kind.append(kind)
            rows.p0.append(block.p0 * s + b)
            rows.e1.append(block.e1 * s + b)
            rows.e2.append(np.zeros((n, 3)))
            rows.uvs.append(
                np.broadcast_to(_DEFAULT_TRI_UVS[None], (n, 3, 2)).copy())
            rows.mat.append(np.full(n, mat_id, np.int32))
            rows.mv0.append(np.broadcast_to(mv0, (n, 3)).copy())
            rows.mv1.append(np.broadcast_to(mv1, (n, 3)).copy())
            rows.rot.append(np.broadcast_to(_EYE9, (n, 9)).copy())
            return
        _bake_block(B.box_faces(block.p0, block.e1), matrix, mv0, mv1,
                    mat_id, rows)
        return
    rot = _EYE9
    if block.kind == PRIM_SPHERE:
        ata = a.T @ a
        s2 = np.trace(ata) / 3.0
        if not np.allclose(ata, s2 * np.eye(3), atol=1e-9 * max(s2, 1.0)):
            # non-uniform linear part: an ellipsoid.  The reference
            # accepts any M44 here (with its Euclidean-only normal
            # caveat, Geometry.hs:382-391); these rows go to the
            # dedicated object-space ellipsoid buffer (ops/ellipsoid.py)
            if ellipsoids is None:
                raise ValueError(
                    "transform: non-uniform-scaled spheres (ellipsoids) "
                    "are not supported as constant_medium boundaries")
            for i in range(n):
                ellipsoids.append((block.p0[i], float(block.e1[i, 0]),
                                   a, b, mat_id, mv0.copy(), mv1.copy()))
            return
        p0 = block.p0 @ a.T + b
        e1 = np.zeros((n, 3))
        e1[:, 0] = block.e1[:, 0] * np.sqrt(s2)
        e2 = np.zeros((n, 3))
        # world->object rotation R^T (R = a / sqrt(s2) is orthogonal):
        # sphere UV is evaluated in object space (the reference
        # inverse-transforms the ray, Geometry.hs:382-391, so sphereUV at
        # Geometry.hs:100-104 sees object coordinates)
        rot = (a.T / np.sqrt(s2)).ravel()
    else:
        p0 = block.p0 @ a.T + b
        e1 = block.e1 @ a.T
        e2 = block.e2 @ a.T
    uvs = (
        np.broadcast_to(_DEFAULT_TRI_UVS[None], (n, 3, 2)).copy()
        if block.uvs is None else np.asarray(block.uvs, np.float64)
    )
    rows.kind.append(kind)
    rows.p0.append(p0)
    rows.e1.append(e1)
    rows.e2.append(e2)
    rows.uvs.append(uvs)
    rows.mat.append(np.full(n, mat_id, np.int32))
    rows.mv0.append(np.broadcast_to(mv0, (n, 3)).copy())
    rows.mv1.append(np.broadcast_to(mv1, (n, 3)).copy())
    rows.rot.append(np.broadcast_to(rot, (n, 9)).copy())


def _walk(node: B.Geom, matrix, mv0, mv1, material, interner, rows: _Rows,
          volumes: list, allow_media: bool, ellipsoids: list | None = None):
    if isinstance(node, B.WithMaterial):
        # Outermost attachment wins (the reference's `<$` functor replaces
        # every value below it, Geometry.hs:44-47).
        eff = material if material is not None else node.material
        _walk(node.child, matrix, mv0, mv1, eff, interner, rows, volumes,
              allow_media, ellipsoids)
    elif isinstance(node, B.Transform):
        _walk(node.child, matrix @ node.matrix, mv0, mv1, material, interner,
              rows, volumes, allow_media, ellipsoids)
    elif isinstance(node, B.Moving):
        lin = matrix[:3, :3]
        _walk(node.child, matrix, mv0 + lin @ node.v0, mv1 + lin @ node.v1,
              material, interner, rows, volumes, allow_media, ellipsoids)
    elif isinstance(node, B.Group):
        for c in node.children:
            _walk(c, matrix, mv0, mv1, material, interner, rows, volumes,
                  allow_media, ellipsoids)
    elif isinstance(node, B.Medium):
        if not allow_media:
            raise ValueError("constant_medium cannot be nested inside another")
        if material is None:
            raise ValueError(
                "constant_medium needs a material attached with with_material"
            )
        vol_rows = _Rows.empty()
        _walk(node.child, matrix, mv0, mv1, None, interner, vol_rows, [],
              allow_media=False, ellipsoids=None)
        if vol_rows.n() == 0:
            raise ValueError("constant_medium: empty boundary geometry")
        volumes.append((node.density, interner.material_id(material), vol_rows))
    elif isinstance(node, B.PrimBlock):
        if node.p0.shape[0] == 0:
            return
        if material is None and allow_media:
            raise ValueError("primitive reached compile without a material; "
                             "wrap it in with_material(...)")
        mat_id = interner.material_id(material) if material is not None else 0
        _bake_block(node, matrix, mv0, mv1, mat_id, rows,
                    ellipsoids=ellipsoids)
    else:
        raise TypeError(f"unknown scene node {type(node)!r}")


# Dense tables of at least _SEGMENT_MIN_PRIMS rows are kind-segmented:
# rows grouped by primitive kind, each group padded to _CLUSTER rows
# (scene/types.py kind_segments).
_CLUSTER = 64
_SEGMENT_MIN_PRIMS = 65

# ``compile_scene(accel="auto")`` keeps up to this many surface rows on
# the dense scan and builds a BVH above it.  The value was chosen for
# another accelerator and is not measured on the card (ROADMAP A3).
MAX_DENSE_PRIMS = 65536


def _rows_to_primitives(rows: _Rows, perm=None, pad_to: int = 1,
                        segment: bool = False,
                        uv_mats: frozenset | None = None) -> Primitives:
    kind = np.concatenate(rows.kind)
    p0 = np.concatenate(rows.p0)
    e1 = np.concatenate(rows.e1)
    e2 = np.concatenate(rows.e2)
    uvs = np.concatenate(rows.uvs)
    mat = np.concatenate(rows.mat)
    mv0 = np.concatenate(rows.mv0)
    mv1 = np.concatenate(rows.mv1)
    rot = np.concatenate(rows.rot)
    if perm is not None:
        kind, p0, e1, e2, uvs, mat, mv0, mv1, rot = (
            x[perm] for x in (kind, p0, e1, e2, uvs, mat, mv0, mv1, rot)
        )
    n = kind.shape[0]

    def _pad(arrs, n_pad):
        kind, p0, e1, e2, uvs, mat, mv0, mv1, rot = arrs
        z3 = np.zeros((n_pad, 3))
        # pad rows get non-degenerate dummy geometry (unit edges) so the
        # vectorized intersection math stays NaN-free under backward AD;
        # kind == PRIM_PAD guarantees they can never be hit
        ex = np.zeros((n_pad, 3)); ex[:, 0] = 1.0
        ey = np.zeros((n_pad, 3)); ey[:, 1] = 1.0
        return (
            np.concatenate([kind, np.full(n_pad, PRIM_PAD, np.int32)]),
            np.concatenate([p0, z3]),
            np.concatenate([e1, ex]),
            np.concatenate([e2, ey]),
            np.concatenate([uvs, np.zeros((n_pad, 3, 2))]),
            np.concatenate([mat, np.zeros(n_pad, np.int32)]),
            np.concatenate([mv0, z3]),
            np.concatenate([mv1, z3]),
            np.concatenate([rot, np.broadcast_to(_EYE9, (n_pad, 9))]),
        )

    arrs = (kind, p0, e1, e2, uvs, mat, mv0, mv1, rot)
    kind_segments = None
    if segment and n >= _SEGMENT_MIN_PRIMS:
        # Re-order rows kind-major (scene/types.py kind_segments).  The
        # spatial (BVH) order is preserved within each kind; each segment
        # is padded to the 64-row cluster width so clusters never mix
        # kinds.
        groups = (
            (PRIM_SPHERE, kind == PRIM_SPHERE),
            (PRIM_PARALLELOGRAM,
             (kind == PRIM_PARALLELOGRAM) | (kind == PRIM_TRIANGLE)),
            (PRIM_BOX, kind == PRIM_BOX),
        )
        pieces = None
        segs = []
        k_cursor = 0
        for gkind, mask in groups:
            idx = np.nonzero(mask)[0]
            if idx.size == 0:
                continue
            part = tuple(a[idx] for a in arrs)
            n_padg = -idx.size % _CLUSTER
            if n_padg:
                part = _pad(part, n_padg)
            n_cl = (idx.size + n_padg) // _CLUSTER
            segs.append((int(gkind), k_cursor, k_cursor + n_cl))
            k_cursor += n_cl
            pieces = part if pieces is None else tuple(
                np.concatenate([a, b]) for a, b in zip(pieces, part))
        arrs = pieces
        kind_segments = tuple(segs)
    else:
        n_pad = -n % pad_to
        if n_pad:
            arrs = _pad(arrs, n_pad)

    kind, p0, e1, e2, uvs, mat, mv0, mv1, rot = arrs
    has_motion = bool(np.any(mv0 != 0.0) or np.any(mv1 != 0.0))
    has_box = bool(np.any(kind == PRIM_BOX))
    # static (row, world->object rotation) list for rotated spheres; the
    # rotation itself is NOT a device buffer — it is applied as an
    # unrolled compare+select at UV evaluation (ops/intersect.py).  Only
    # rows whose material's texture actually CONSUMES uv are kept
    # (``uv_mats``): demo2's 1000-sphere constant-color cloud is rotated
    # but uv-blind, and a 1000-entry unrolled chain would dwarf the
    # intersection itself.  None = keep all (unknown materials).
    rotated = (kind == PRIM_SPHERE) & (np.abs(rot - _EYE9).max(axis=1) > 1e-9)
    if uv_mats is not None:
        rotated &= np.isin(mat, np.asarray(sorted(uv_mats), np.int32))
    rot_rows = np.nonzero(rotated)[0]
    sphere_rots = tuple(
        (int(r), tuple(np.asarray(rot[r], np.float32).tolist()))
        for r in rot_rows)
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    return Primitives(
        kind=jnp.asarray(kind), p0=f32(p0), e1=f32(e1), e2=f32(e2),
        uvs=f32(uvs), mat=jnp.asarray(mat), mv0=f32(mv0), mv1=f32(mv1),
        n=int(n), has_motion=has_motion, has_box=has_box,
        kind_segments=kind_segments,
        sphere_rots=sphere_rots,
    )


def compile_scene(root: B.Geom, *, accel: str = "auto", leaf_size: int = 4,
                  dense_threshold: int | None = None,
                  pad_to: int = 8) -> Scene:
    """Compile a scene graph into a :class:`Scene` of device buffers.

    ``accel``: "auto" (BVH above ``dense_threshold`` primitives, default
    :data:`MAX_DENSE_PRIMS`), "dense", or "bvh".
    """
    if dense_threshold is None:
        dense_threshold = MAX_DENSE_PRIMS
    interner = _Interner()
    rows = _Rows.empty()
    volumes: list = []
    ellipsoids: list = []
    _walk(root, np.eye(4), np.zeros(3), np.zeros(3), None, interner, rows,
          volumes, allow_media=True, ellipsoids=ellipsoids)
    if rows.n() == 0 and not volumes and not ellipsoids:
        raise ValueError("compile_scene: empty scene")

    n_surface = rows.n()
    use_bvh = accel == "bvh" or (accel == "auto" and n_surface > dense_threshold)

    bvh = None
    perm = None
    if n_surface > 0:
        kind = np.concatenate(rows.kind)
        p0 = np.concatenate(rows.p0)
        e1 = np.concatenate(rows.e1)
        e2 = np.concatenate(rows.e2)
        mv0 = np.concatenate(rows.mv0)
        mv1 = np.concatenate(rows.mv1)
        lo, hi = prim_aabbs(kind, p0, e1, e2, mv0, mv1)
        # Both modes order primitives spatially by the median-split
        # permutation: BVH mode needs it for contiguous leaves; dense mode
        # keeps it so fixed-width row clusters have tight bounding boxes.
        perm, nodes = build_bvh(lo, hi, leaf_size=leaf_size)
        if use_bvh:
            bvh = BVH(
                lo=jnp.asarray(nodes["lo"]), hi=jnp.asarray(nodes["hi"]),
                start=jnp.asarray(nodes["start"]),
                count=jnp.asarray(nodes["count"]),
                skip=jnp.asarray(nodes["skip"]),
                n_nodes=int(nodes["lo"].shape[0]),
            )

    # material ids whose texture consumes uv (checker/image/custom):
    # only their rotated spheres need the object-space UV correction
    from ..textures.textures import TEX_CHECKER, TEX_CUSTOM, TEX_IMAGE
    uv_mats = frozenset(
        mid for m, mid in interner.materials.items()
        if m.texture.kind in (TEX_CHECKER, TEX_IMAGE, TEX_CUSTOM))
    prims = _rows_to_primitivies_or_empty(rows, perm, pad_to,
                                          segment=not use_bvh,
                                          uv_mats=uv_mats)

    vol = None
    if volumes:
        starts = []
        counts = []
        merged = _Rows.empty()
        for density, mat_id, vrows in volumes:
            starts.append(merged.n())
            counts.append(vrows.n())
            for field in ("kind", "p0", "e1", "e2", "uvs", "mat", "mv0",
                          "mv1", "rot"):
                getattr(merged, field).extend(getattr(vrows, field))
        # volume boundaries never evaluate uv (the medium overrides it)
        vol_prims = _rows_to_primitives(merged, None, 1,
                                        uv_mats=frozenset())
        vol = Volumes(
            prims=vol_prims,
            density=jnp.asarray([v[0] for v in volumes], jnp.float32),
            mat=jnp.asarray([v[1] for v in volumes], jnp.int32),
            starts=tuple(starts), counts=tuple(counts),
        )

    ell = None
    if ellipsoids:
        from .types import Ellipsoids
        centers = np.stack([e[0] for e in ellipsoids])
        fwd = np.stack([e[2] for e in ellipsoids])
        emv0 = np.stack([e[5] for e in ellipsoids])
        emv1 = np.stack([e[6] for e in ellipsoids])
        ell = Ellipsoids(
            center=jnp.asarray(centers, jnp.float32),
            radius=jnp.asarray([e[1] for e in ellipsoids], jnp.float32),
            fwd=jnp.asarray(fwd, jnp.float32),
            inv=jnp.asarray(np.linalg.inv(fwd), jnp.float32),
            shift=jnp.asarray(np.stack([e[3] for e in ellipsoids]),
                              jnp.float32),
            mat=jnp.asarray([e[4] for e in ellipsoids], jnp.int32),
            mv0=jnp.asarray(emv0, jnp.float32),
            mv1=jnp.asarray(emv1, jnp.float32),
            n=len(ellipsoids),
            has_motion=bool(np.any(emv0 != 0.0) or np.any(emv1 != 0.0)),
        )

    textures = compile_textures(list(interner.textures))
    materials = compile_materials(list(interner.materials), interner.textures)
    return Scene(prims=prims, materials=materials, textures=textures,
                 bvh=bvh, volumes=vol, ellipsoids=ell)


def _rows_to_primitivies_or_empty(rows: _Rows, perm, pad_to,
                                  segment: bool = False,
                                  uv_mats: frozenset | None = None
                                  ) -> Primitives:
    if rows.n() == 0:
        z3 = jnp.zeros((1, 3), jnp.float32)
        return Primitives(
            kind=jnp.full((1,), PRIM_PAD, jnp.int32), p0=z3, e1=z3, e2=z3,
            uvs=jnp.zeros((1, 3, 2), jnp.float32),
            mat=jnp.zeros((1,), jnp.int32), mv0=z3, mv1=z3, n=0,
            has_motion=False,
        )
    return _rows_to_primitives(rows, perm, pad_to, segment=segment,
                               uv_mats=uv_mats)
