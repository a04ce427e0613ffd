"""One bounce of every material against a float64 numpy reference.

Rays hit the front of one large quad; with fixed uniforms, the integrator's
:func:`bounce` must produce the scattered origin, direction, throughput,
emitted radiance and survival that the reference formulas give
(Material.hs:41-129, Ray.hs:174-224 incl. MIS light redirection).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import raytrace_tpu as rt
from raytrace_tpu.render.integrator import bounce, n_bounce_uniforms

ALBEDO = np.array([0.7, 0.5, 0.3])
FUZZ, IOR, G = 0.3, 1.5, 0.6
QUAD = ([-4.0, -4.0, -5.0], [8.0, 0.0, 0.0], [0.0, 8.0, 0.0])   # normal +z
TARGET = (0.5, [-1.0, 3.0, -3.0], [2.0, 0.0, 0.0], [0.0, 0.0, 2.0])

MATERIALS = {
    "lambertian": lambda t: rt.lambertian(t),
    "lommel": lambda t: rt.lommel_seeliger(t),
    "isotropic": lambda t: rt.isotropic(t),
    "anisotropic": lambda t: rt.anisotropic(G, t),
    "mirror": lambda t: rt.mirror(t),
    "metal": lambda t: rt.metal(FUZZ, t),
    "dielectric": lambda t: rt.dielectric(IOR),
    "transparent": lambda t: rt.transparent(t),
    "light": lambda t: rt.light_source(t),
    "pitch_black": lambda t: rt.pitch_black(),
}
CASES = [(m, False) for m in MATERIALS] + [
    (m, True) for m in ("lambertian", "lommel", "isotropic")]


def _unit(u, v):
    z = 1.0 - 2.0 * u
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    phi = 2.0 * np.pi * v
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], -1)


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _dot(a, b):
    return np.sum(a * b, -1)


def _target_pdf(point, dirs):
    """Reference per-target pdf term t^2 / |cross . dir| where the ray
    from ``point`` along ``dirs`` hits the target (Ray.hs:199-204)."""
    prob, q, u, v = (np.asarray(x, np.float64) for x in TARGET)
    cp = np.cross(u, v)
    n = cp / np.linalg.norm(cp)
    den = dirs @ n
    t = ((q - point) @ n) / den
    p = point + t[:, None] * dirs - q
    ns = cp / (cp @ cp)
    a = np.cross(v, ns) @ p.T
    b = np.cross(ns, u) @ p.T
    hit = (np.abs(den) > 1e-8) & (t > 0) & (a >= 0) & (a <= 1) & \
        (b >= 0) & (b <= 1)
    return np.where(hit, prob * t * t / np.abs(dirs @ cp), 0.0)


def _reference(name, redirect, o, d, uni, rad, thr):
    normal = np.array([0.0, 0.0, 1.0])
    t = (QUAD[0][2] - o[:, 2]) / d[:, 2]
    point = o + t[:, None] * d
    alb = ALBEDO[None, :]
    refl = d - 2.0 * _dot(d, normal)[:, None] * normal
    alive = np.ones(len(o), bool)
    new_d = d.copy()
    weight = np.ones_like(d)
    if name == "light":
        return point, d, rad + thr * alb, thr, np.zeros(len(o), bool)
    if name == "pitch_black":
        return point, d, rad, thr, np.zeros(len(o), bool)
    if name in ("mirror", "transparent"):
        new_d = refl if name == "mirror" else d
        weight = np.broadcast_to(alb, d.shape)
    elif name == "metal":
        m = refl + FUZZ * _unit(uni[:, 0], uni[:, 1])
        alive = _dot(m, normal) > 0
        new_d = _norm(m)
        weight = np.broadcast_to(alb, d.shape)
    elif name == "dielectric":
        ratio = 1.0 / IOR                          # front face
        cos = np.minimum(1.0, _dot(normal, -d))
        sin = np.sqrt(1.0 - cos * cos)
        r0 = ((1 - ratio) / (1 + ratio)) ** 2
        schlick = r0 + (1 - r0) * (1 - cos) ** 5
        perp = ratio * (d + cos[:, None] * normal)
        refr = perp - np.sqrt(np.abs(1 - _dot(perp, perp)))[:, None] * normal
        refl_now = (ratio * sin > 1.0) | (uni[:, 2] < schlick)
        new_d = np.where(refl_now[:, None], refl, refr)
    else:
        u = _unit(uni[:, 3], uni[:, 4])
        hemi = name in ("lambertian", "lommel")
        base = _norm(normal + u) if hemi else u
        if redirect:
            prob, q, eu, ev = (np.asarray(x, np.float64) for x in TARGET)
            use = uni[:, 5] < prob      # CDF: first target with x < cdf
            lp = q + uni[:, 6:7] * eu + uni[:, 7:8] * ev
            new_d = np.where(use[:, None], _norm(lp - point), base)
        else:
            new_d = base
        mu1 = _dot(new_d, normal)
        pdf_base = mu1 / np.pi if hemi else np.full(len(o), 0.25 / np.pi)
        alive = ~(hemi & (pdf_base <= 0))
        pdf_mix = pdf_base
        if redirect:
            pdf_mix = (1 - TARGET[0]) * pdf_base + _target_pdf(point, new_d)
        pdf_mix = np.maximum(pdf_mix, 1e-12)
        brdf = np.ones(len(o))
        if name == "lommel":
            brdf = 0.25 / np.maximum(-_dot(d, normal) + mu1, 1e-8)
        elif name == "anisotropic":
            mu = _dot(d, new_d)
            brdf = (1 - G * G) / np.maximum(1 + G * G - 2 * G * mu,
                                            1e-12) ** 1.5
        weight = alb * (brdf * pdf_base / pdf_mix)[:, None]
    thr2 = np.where(alive[:, None], thr * weight, thr)
    return (np.where(alive[:, None], point, o),
            np.where(alive[:, None], new_d, d), rad, thr2, alive)


@pytest.mark.parametrize("name,redirect", CASES,
                         ids=[f"{m}-{'redirect' if r else 'plain'}"
                              for m, r in CASES])
def test_one_bounce_matches_reference(name, redirect):
    tex = rt.constant_texture(ALBEDO)
    world = rt.with_material(MATERIALS[name](tex), rt.parallelogram(*QUAD))
    scene = rt.compile_scene(world)
    s = rt.CameraSettings(background=rt.const_background(0.0))
    if redirect:
        s = s.with_redirect_targets([TARGET])
    r = 512
    rng = np.random.default_rng(CASES.index((name, redirect)))
    o = np.zeros((r, 3))
    d = _norm(np.stack([rng.uniform(-0.5, 0.5, r), rng.uniform(-0.5, 0.5, r),
                        -np.ones(r)], -1))
    uni = rng.uniform(0.0, 1.0, (r, n_bounce_uniforms(scene)))
    rad = rng.uniform(0.0, 0.2, (r, 3))
    thr = rng.uniform(0.5, 1.0, (r, 3))
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    out = bounce(scene, s, f32(o), f32(d), jnp.zeros(r, jnp.float32),
                 f32(uni), f32(rad), f32(thr), jnp.ones(r, bool))
    o2, d2, rad2, thr2, alive2, died = (np.asarray(x) for x in out)
    ref = _reference(name, redirect, o, d, uni.astype(np.float32)
                     .astype(np.float64), rad, thr)
    np.testing.assert_array_equal(alive2, ref[4])
    np.testing.assert_array_equal(died, ~ref[4])
    np.testing.assert_allclose(rad2, ref[2], rtol=1e-5, atol=1e-6)
    live = ref[4]
    np.testing.assert_allclose(o2[live], ref[0][live], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d2[live], ref[1][live], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(thr2, ref[3], rtol=1e-4, atol=1e-6)
