"""Camera model and primary-ray generation.

Mirrors the reference ``CameraSettings`` (all 12 fields, Ray.hs:40-98) and
its pinhole + thin-lens model (Ray.hs:123-172): orthonormal basis (u, v, w)
from center/look_at/up, viewport sized by vfov x focus_dist, per-sample
pixel jitter, defocus-disk origin sampling.  Ray generation is vectorized
over a whole batch of (pixel, sample) pairs.

``background`` is a jittable callable ``(origin[...,3], dir[...,3]) ->
color[...,3]`` — the reference's ``cs_background :: Ray -> Color``
(Ray.hs:57).  ``sky`` and ``gray_fade`` reproduce the gradients of
test/Main.hs:19-28.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from ..core import struct

from ..core import rng
from ..core.vecmath import DTYPE, normalize, vcross


def const_background(color):
    c = jnp.asarray(color, DTYPE) * jnp.ones(3, DTYPE)

    def bg(o, d):
        return jnp.broadcast_to(c, d.shape)
    return bg


def sky(o, d):
    """Blue-white vertical gradient (test/Main.hs:19-23)."""
    a = 0.5 * (d[..., 1:2] + 1.0)
    white = jnp.asarray([1.0, 1.0, 1.0], DTYPE)
    blue = jnp.asarray([0.5, 0.7, 1.0], DTYPE)
    return (1.0 - a) * white + a * blue


def gray_fade(o, d):
    """Gray vertical gradient (test/Main.hs:25-28)."""
    t = (d[..., 1:2] + 1.0) * 0.5
    return jnp.broadcast_to(t, d.shape).astype(DTYPE) * jnp.ones(3, DTYPE)


class CameraSettings(struct.PyTreeNode):
    """The reference's 12 camera fields (Ray.hs:40-68).  Numeric fields are
    traced pytree leaves (differentiable); sizes/counts and the background
    callable are static."""
    center: jnp.ndarray = struct.field(default_factory=lambda: jnp.zeros(3, DTYPE))
    look_at: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.asarray([0.0, 0.0, -1.0], DTYPE))
    up: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.asarray([0.0, 1.0, 0.0], DTYPE))
    vfov: float = jnp.pi / 2
    defocus_angle: float = 0.0
    focus_dist: float = 10.0
    # redirect targets (Ray.hs:64-67): probabilities should sum to < 1
    redirect_prob: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.zeros((0,), DTYPE))
    redirect_q: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.zeros((0, 3), DTYPE))
    redirect_u: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.zeros((0, 3), DTYPE))
    redirect_v: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.zeros((0, 3), DTYPE))
    # static configuration
    aspect_ratio: float = struct.field(pytree_node=False, default=1.0)
    image_width: int = struct.field(pytree_node=False, default=100)
    samples_per_pixel: int = struct.field(pytree_node=False, default=10)
    max_depth: int = struct.field(pytree_node=False, default=10)
    background: Callable = struct.field(
        pytree_node=False, default_factory=lambda: const_background(1.0))
    t_min: float = struct.field(pytree_node=False, default=1e-3)
    # Russian roulette (NOT in the reference — opt-in production feature):
    # from bounce depth >= rr_depth, a path survives with probability
    # clamp(max(throughput), rr_min, 1) and its throughput is divided by
    # that probability (unbiased).  None = off = exact reference estimator.
    rr_depth: int | None = struct.field(pytree_node=False, default=None)
    rr_min: float = struct.field(pytree_node=False, default=0.05)

    @property
    def image_height(self) -> int:
        # round(width / aspect) (Ray.hs:123)
        return max(1, round(self.image_width / self.aspect_ratio))

    @property
    def n_redirect(self) -> int:
        return self.redirect_q.shape[0]

    def with_redirect_targets(self, targets) -> "CameraSettings":
        """targets: iterable of (prob, corner, edge_u, edge_v)."""
        targets = list(targets)
        if not targets:
            return self
        prob = jnp.asarray([t[0] for t in targets], DTYPE)
        q = jnp.asarray([t[1] for t in targets], DTYPE).reshape(-1, 3)
        u = jnp.asarray([t[2] for t in targets], DTYPE).reshape(-1, 3)
        v = jnp.asarray([t[3] for t in targets], DTYPE).reshape(-1, 3)
        return self.replace(redirect_prob=prob, redirect_q=q, redirect_u=u,
                            redirect_v=v)


def camera_frame(s: CameraSettings):
    """Precompute the viewport frame (Ray.hs:123-136)."""
    h = s.image_height
    w = s.image_width
    viewport_h = s.focus_dist * jnp.tan(s.vfov / 2.0) * 2.0
    viewport_w = viewport_h * (w / h)
    wv = normalize(s.center - s.look_at)
    uv = normalize(vcross(s.up, wv))
    vv = vcross(wv, uv)
    across = viewport_w * uv
    down = -(viewport_h * vv)
    top_left = s.center - wv * s.focus_dist - across / 2.0 - down / 2.0
    pixel_u = across / w
    pixel_v = down / h
    defocus_radius = s.focus_dist * jnp.tan(s.defocus_angle / 2.0)
    return dict(u=uv, v=vv, top_left=top_left, pixel_u=pixel_u,
                pixel_v=pixel_v, defocus_radius=defocus_radius)


def generate_rays_from_uniforms(s: CameraSettings, frame, pixel_ids, u5):
    """Primary rays for flat pixel indices ``pixel_ids[R]`` from a
    [R, 5] uniform block (disk x2, pixel jitter x2, time).

    Semantics of getRay/samplePixel/sampleDefocusDisk (Ray.hs:153-172):
    thin-lens origin on the defocus disk, jittered target inside the pixel
    footprint, unit direction; per-sample time in [0,1) for motion blur
    (Ray.hs:229-230).
    """
    w = s.image_width
    i = (pixel_ids % w).astype(DTYPE)
    j = (pixel_ids // w).astype(DTYPE)

    disk = rng.disk_from_uniforms(u5[:, 0], u5[:, 1])
    origin = (s.center
              + disk[:, 0:1] * (frame["defocus_radius"] * frame["u"])
              + disk[:, 1:2] * (frame["defocus_radius"] * frame["v"]))
    target = (frame["top_left"]
              + (i + u5[:, 2])[:, None] * frame["pixel_u"]
              + (j + u5[:, 3])[:, None] * frame["pixel_v"])
    direction = normalize(target - origin)
    return origin, direction, u5[:, 4]


def generate_rays(s: CameraSettings, frame, pixel_ids, keys):
    """Primary rays from per-ray keys (one uniform block per lane)."""
    u5 = rng.uniform_block(rng.site(keys, 0), 5)
    return generate_rays_from_uniforms(s, frame, pixel_ids, u5)


def generate_ray_components(s: CameraSettings, frame, pixel_ids, u5):
    """Like :func:`generate_rays_from_uniforms` but computed and returned
    as seven 1-D component arrays (ox, oy, oz, dx, dy, dz, time) — the
    wavefront keeps its lane state as SoA 1-D arrays."""
    w = s.image_width
    i = (pixel_ids % w).astype(DTYPE)
    j = (pixel_ids // w).astype(DTYPE)
    r = jnp.sqrt(u5[:, 0])
    th = (2.0 * jnp.pi) * u5[:, 1]
    da = r * jnp.cos(th) * frame["defocus_radius"]
    db = r * jnp.sin(th) * frame["defocus_radius"]
    uu, vv = frame["u"], frame["v"]
    tl, pu, pv = frame["top_left"], frame["pixel_u"], frame["pixel_v"]
    ii = i + u5[:, 2]
    jj = j + u5[:, 3]
    out_o = []
    out_d = []
    for k in range(3):
        ok = s.center[k] + da * uu[k] + db * vv[k]
        tk = tl[k] + ii * pu[k] + jj * pv[k]
        out_o.append(ok)
        out_d.append(tk - ok)
    inv = jax.lax.rsqrt(jnp.maximum(
        out_d[0] * out_d[0] + out_d[1] * out_d[1] + out_d[2] * out_d[2],
        1e-24))
    return (out_o[0], out_o[1], out_o[2], out_d[0] * inv, out_d[1] * inv,
            out_d[2] * inv, u5[:, 4])
