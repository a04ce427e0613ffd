"""Texture system: builder-side descriptors + a flat, jit-friendly table.

The reference represents a texture as an opaque Haskell closure
``Point3 -> UV -> Color`` (Texture.hs:15) with seven constructors
(Texture.hs:18-79).  Closures don't exist on a device; instead every
texture in a scene is *interned* into a struct-of-arrays table (one row
per texture) and evaluated branchlessly for whole ray batches, gathering
per-lane parameters by texture id.  Only the texture kinds actually
present in the scene are computed (static specialization — scene topology
is static under jit), then combined with ``jnp.where``.

Image textures are packed into a single padded atlas ``[n_images, H, W, 3]``
so a batch of lookups is one gather.  Arbitrary user closures are supported
via ``custom_texture`` — any jittable ``f(points, uvs) -> colors`` — which
covers the reference's ``solidTexture``/``uvTexture`` generality
(Texture.hs:21-27).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import jax.numpy as jnp
from ..core import struct

from ..core.vecmath import DTYPE, vdot0
from .noise import fractal_noise, turbulence

# Texture kinds
TEX_CONSTANT = 0
TEX_CHECKER = 1
TEX_IMAGE = 2
TEX_NOISE = 3
TEX_MARBLE = 4
TEX_CUSTOM = 5


# ---------------------------------------------------------------------------
# Builder-side descriptors (plain Python; interned at scene compile)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Texture:
    """A texture descriptor. ``c0``/``c1`` are colors, ``v0``/``v1`` generic
    vector params, ``f0``/``f1`` scalar params, ``i0`` an integer param
    (octave count / image index), ``image`` an [H, W, 3] array for image
    textures, ``fn`` a jittable closure for custom textures."""
    kind: int
    c0: Any = (0.0, 0.0, 0.0)
    c1: Any = (0.0, 0.0, 0.0)
    v0: Any = (0.0, 0.0, 0.0)
    v1: Any = (0.0, 0.0, 0.0)
    f0: Any = 0.0
    f1: Any = 0.0
    i0: int = 0
    image: Any = None
    fn: Callable | None = None

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


def constant_texture(color) -> Texture:
    """Same color everywhere (Texture.hs:18-19)."""
    return Texture(TEX_CONSTANT, c0=_c3(color))


def checker_texture(n_u: int, n_v: int, c0, c1) -> Texture:
    """UV checkerboard with ``n_u`` x ``n_v`` cells (Texture.hs:46-56)."""
    return Texture(TEX_CHECKER, c0=_c3(c0), c1=_c3(c1), f0=float(n_u), f1=float(n_v))


def image_texture(image) -> Texture:
    """Image lookup: (u,v)=(0,0) is bottom-left, wrap-around, nearest sample
    (Texture.hs:29-43). ``image`` is an [H, W, 3] linear-RGB array."""
    return Texture(TEX_IMAGE, image=np.asarray(image, np.float32))


def noise_texture(k: int, freq: float, shift, color0, color1) -> Texture:
    """Fractal-noise lerp between two colors (Texture.hs:58-70)."""
    return Texture(TEX_NOISE, c0=_c3(color0), c1=_c3(color1), v0=_c3(shift),
                   f0=float(freq), i0=int(k))


def marble_texture(direction, freq: float, shift=(0.0, 0.0, 0.0)) -> Texture:
    """Noisy sine stripes along ``direction`` (Texture.hs:72-79)."""
    return Texture(TEX_MARBLE, v0=_c3(direction), v1=_c3(shift), f0=float(freq))


def custom_texture(fn: Callable) -> Texture:
    """Arbitrary jittable ``fn(points[...,3], uvs[...,2]) -> colors[...,3]``;
    subsumes the reference's solidTexture/uvTexture closures."""
    return Texture(TEX_CUSTOM, fn=fn)


def solid_texture(fn: Callable) -> Texture:
    """Point-dependent color (Texture.hs:21-23)."""
    return custom_texture(lambda p, uv: fn(p))


def uv_texture(fn: Callable) -> Texture:
    """UV-dependent color (Texture.hs:25-27)."""
    return custom_texture(lambda p, uv: fn(uv))


def _c3(x):
    x = np.asarray(x, np.float64)
    if x.ndim == 0:
        x = np.full((3,), float(x))
    return tuple(float(v) for v in x)


# ---------------------------------------------------------------------------
# Compiled table
# ---------------------------------------------------------------------------

class TextureTable(struct.PyTreeNode):
    kind: jnp.ndarray            # i32[T]
    c0: jnp.ndarray              # f32[T,3]
    c1: jnp.ndarray              # f32[T,3]
    v0: jnp.ndarray              # f32[T,3]
    v1: jnp.ndarray              # f32[T,3]
    f0: jnp.ndarray              # f32[T]
    f1: jnp.ndarray              # f32[T]
    i0: jnp.ndarray              # i32[T]
    images: jnp.ndarray          # f32[I,H,W,3] atlas (I>=1; dummy if unused)
    image_hw: jnp.ndarray        # i32[I,2] true (h, w) per image
    kinds_present: tuple = struct.field(pytree_node=False, default=())
    noise_octaves: tuple = struct.field(pytree_node=False, default=())
    custom_fns: tuple = struct.field(pytree_node=False, default=())


def compile_textures(textures: Sequence[Texture]) -> TextureTable:
    """Intern a list of descriptors into a TextureTable. Index in the list is
    the texture id referenced by the material table."""
    n = max(len(textures), 1)
    kind = np.zeros(n, np.int32)
    c0 = np.zeros((n, 3), np.float32)
    c1 = np.zeros((n, 3), np.float32)
    v0 = np.zeros((n, 3), np.float32)
    v1 = np.zeros((n, 3), np.float32)
    f0 = np.zeros(n, np.float32)
    f1 = np.zeros(n, np.float32)
    i0 = np.zeros(n, np.int32)

    images: list[np.ndarray] = []
    custom_fns: list[Callable] = []
    octaves: set[int] = set()

    for t_idx, t in enumerate(textures):
        kind[t_idx] = t.kind
        c0[t_idx] = t.c0
        c1[t_idx] = t.c1
        v0[t_idx] = t.v0
        v1[t_idx] = t.v1
        f0[t_idx] = t.f0
        f1[t_idx] = t.f1
        if t.kind == TEX_IMAGE:
            i0[t_idx] = len(images)
            images.append(np.asarray(t.image, np.float32))
        elif t.kind == TEX_CUSTOM:
            i0[t_idx] = len(custom_fns)
            custom_fns.append(t.fn)
        else:
            i0[t_idx] = t.i0
            if t.kind == TEX_NOISE:
                octaves.add(int(t.i0))

    if images:
        max_h = max(im.shape[0] for im in images)
        max_w = max(im.shape[1] for im in images)
        atlas = np.zeros((len(images), max_h, max_w, 3), np.float32)
        hw = np.zeros((len(images), 2), np.int32)
        for idx, im in enumerate(images):
            atlas[idx, : im.shape[0], : im.shape[1]] = im
            hw[idx] = im.shape[:2]
    else:
        atlas = np.zeros((1, 1, 1, 3), np.float32)
        hw = np.ones((1, 2), np.int32)

    kinds_present = tuple(sorted(set(int(k) for k in kind[: len(textures)])))
    return TextureTable(
        kind=jnp.asarray(kind), c0=jnp.asarray(c0), c1=jnp.asarray(c1),
        v0=jnp.asarray(v0), v1=jnp.asarray(v1), f0=jnp.asarray(f0),
        f1=jnp.asarray(f1), i0=jnp.asarray(i0), images=jnp.asarray(atlas),
        image_hw=jnp.asarray(hw), kinds_present=kinds_present,
        noise_octaves=tuple(sorted(octaves)), custom_fns=tuple(custom_fns),
    )


# ---------------------------------------------------------------------------
# Batched evaluation
# ---------------------------------------------------------------------------

def eval_texture(table: TextureTable, tex_ids, points, uvs,
                 onehot: bool = False):
    """Evaluate texture ``tex_ids[...]`` at ``points[..., 3]`` / ``uvs[..., 2]``.

    Branchless over lanes; only kinds present in the scene are computed.

    ``onehot=True`` (differentiable path, 1-D ``tex_ids`` only) gathers
    the float parameter tables with a single one-hot matmul so the
    backward is scatter-free (core/vecmath.py:onehot_rows).
    """
    kind = table.kind[tex_ids]
    if onehot:
        from ..core.vecmath import gather_rows, onehot_rows
        nt = table.kind.shape[0]
        oh = onehot_rows(tex_ids, nt)
        allf = gather_rows(oh, jnp.concatenate(
            [table.c0, table.c1, table.v0, table.v1,
             table.f0[:, None], table.f1[:, None]], axis=1))
        c0, c1 = allf[:, 0:3], allf[:, 3:6]
        v0_r, v1_r = allf[:, 6:9], allf[:, 9:12]
        f0_r, f1_r = allf[:, 12], allf[:, 13]
    else:
        c0 = table.c0[tex_ids]
        c1 = v0_r = v1_r = f0_r = f1_r = None
    out = c0  # TEX_CONSTANT result; also the base for others

    _c1 = (lambda: c1) if onehot else (lambda: table.c1[tex_ids])
    _v0 = (lambda: v0_r) if onehot else (lambda: table.v0[tex_ids])
    _v1 = (lambda: v1_r) if onehot else (lambda: table.v1[tex_ids])
    _f0 = (lambda: f0_r) if onehot else (lambda: table.f0[tex_ids])
    _f1 = (lambda: f1_r) if onehot else (lambda: table.f1[tex_ids])

    if TEX_CHECKER in table.kinds_present:
        # floor(u * n_u) + floor(v * n_v) parity (Texture.hs:46-56)
        n_u = _f0()
        n_v = _f1()
        i = jnp.floor(uvs[..., 0] * n_u).astype(jnp.int32)
        j = jnp.floor(uvs[..., 1] * n_v).astype(jnp.int32)
        even = ((i + j) & 1) == 0
        checker = jnp.where(even[..., None], c0, _c1())
        out = jnp.where((kind == TEX_CHECKER)[..., None], checker, out)

    if TEX_IMAGE in table.kinds_present:
        img_id = table.i0[tex_ids]
        hw = table.image_hw[img_id]
        h = hw[..., 0]
        w = hw[..., 1]
        # i = floor(u*w) mod w ; j = floor((1-v)*h) mod h (Texture.hs:36-42)
        i = jnp.mod(jnp.floor(uvs[..., 0] * w).astype(jnp.int32), jnp.maximum(w, 1))
        j = jnp.mod(jnp.floor((1.0 - uvs[..., 1]) * h).astype(jnp.int32), jnp.maximum(h, 1))
        texel = table.images[img_id, j, i]
        out = jnp.where((kind == TEX_IMAGE)[..., None], texel, out)

    if TEX_NOISE in table.kinds_present:
        freq = _f0()
        shift = _v0()
        c1n = _c1()
        scale = 0.5 / 0.8  # Texture.hs:66
        # Octave count is per-texture but static per scene; compute each
        # distinct octave depth once and select.
        q = points * freq[..., None] + shift
        n = jnp.zeros(points.shape[:-1], DTYPE)
        for k in table.noise_octaves:
            nk = fractal_noise(k, q)
            n = jnp.where(table.i0[tex_ids] == k, nk, n)
        val = (n * scale + 0.5)[..., None]
        noise_col = c0 + (c1n - c0) * val
        out = jnp.where((kind == TEX_NOISE)[..., None], noise_col, out)

    if TEX_MARBLE in table.kinds_present:
        direction = _v0()
        shift = _v1()
        freq = _f0()
        sin_arg = freq * vdot0(direction, points)
        nz = 10.0 * turbulence(7, 0.25 * freq[..., None] * points + shift)
        stripe = 0.5 + 0.5 * jnp.sin(sin_arg + nz)  # Texture.hs:72-79
        out = jnp.where((kind == TEX_MARBLE)[..., None], stripe[..., None], out)

    if TEX_CUSTOM in table.kinds_present:
        for fn_idx, fn in enumerate(table.custom_fns):
            val = jnp.broadcast_to(
                jnp.asarray(fn(points, uvs), DTYPE), points.shape
            )
            sel = jnp.logical_and(kind == TEX_CUSTOM, table.i0[tex_ids] == fn_idx)
            out = jnp.where(sel[..., None], val, out)

    return out
