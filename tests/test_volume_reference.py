"""The volume crossing scan against a float64 numpy reference.

``render/volumes.py:volume_candidates`` finds, per ray and medium, the
two smallest boundary crossings beyond ``t_min`` and the front flag of
the first; entry/exit and the exponential free-flight scatter candidate
follow (Geometry.hs:298-330).  The reference below recomputes all of it
per ray in f64 for sphere, box, triangle-mesh, two-medium and moving
boundaries.  Rays whose crossings sit within rounding of a decision are
not held to the result.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import raytrace_tpu as rt
from raytrace_tpu.render.volumes import volume_candidates
from raytrace_tpu.scene.types import (
    PRIM_BOX, PRIM_PARALLELOGRAM, PRIM_SPHERE,
)

T_MIN = 1e-3
EDGE = 1e-4


def _mesh_sphere(center, radius):
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tools"))
    from bench_bigmesh import uv_sphere
    v, f = uv_sphere(8, 12)
    return rt.triangle_mesh(rt.Mesh(vertices=v * radius + center,
                                    uv=np.zeros((0, 2)), faces=f,
                                    uv_faces=np.full_like(f, -1)))


def _medium(density, geom):
    return rt.with_material(rt.isotropic(rt.constant_texture(0.5)),
                            rt.constant_medium(density, geom))


BOUNDARIES = {
    "sphere": lambda: [_medium(0.6, rt.sphere([0, 0, 0], 2.0))],
    "box": lambda: [_medium(0.6, rt.cuboid([-2, -1.5, -1], [2, 1.5, 1]))],
    "mesh": lambda: [_medium(0.6, _mesh_sphere(np.zeros(3), 2.0))],
    "two": lambda: [_medium(0.4, rt.sphere([-1.5, 0, 0], 1.5)),
                    _medium(1.2, rt.cuboid([0.5, -1, -1], [2.5, 1, 1]))],
    "moving": lambda: [_medium(0.6, rt.moving(
        [0, 0, 0], [1.5, 0.5, 0], rt.sphere([0, 0, 0], 2.0)))],
}


def _crossings(kind, p0, e1, e2, o, d):
    """All (t, entering) boundary crossings of one ray with one row,
    plus the row's decision margin."""
    if kind == PRIM_SPHERE:
        oc = p0 - o
        h = d @ oc
        c = oc @ oc - e1[0] ** 2
        disc = h * h - c
        margin = abs(disc) / (h * h + abs(c) + 1e-12)
        if disc < 0:
            return [], margin
        s = np.sqrt(disc)
        return [(h - s, True), (h + s, False)], margin
    if kind == PRIM_BOX:
        with np.errstate(divide="ignore", invalid="ignore"):
            t0, t1 = (p0 - o) / d, (e1 - o) / d
        tn = np.max(np.minimum(t0, t1))
        tf = np.min(np.maximum(t0, t1))
        margin = abs(tf - tn) / (abs(tn) + 1.0)
        return ([(tn, True), (tf, False)] if tn <= tf else []), margin
    n = np.cross(e1, e2)
    den = n @ d / np.linalg.norm(n)
    if abs(den) <= 1e-8:
        return [], np.inf
    t = (n / np.linalg.norm(n)) @ (p0 - o) / den
    p = o + t * d - p0
    ns = n / (n @ n)
    a, b = ns @ np.cross(p, e2), ns @ np.cross(e1, p)
    edges = [a, 1 - a, b, 1 - b] if kind == PRIM_PARALLELOGRAM else \
        [a, b, 1 - a - b]
    margin = min(abs(x) for x in edges)
    return ([(t, den < 0)] if min(edges) >= 0 else []), margin


def _reference(vol, o, d, time, u):
    p = vol.prims
    kind = np.asarray(p.kind)
    p0, e1, e2, mv0, mv1 = (np.asarray(x, np.float64) for x in (
        p.p0, p.e1, p.e2, p.mv0, p.mv1))
    dens = np.asarray(vol.density, np.float64)
    r, nv = o.shape[0], vol.n_volumes
    cand = np.full((r, nv), np.inf)
    ambiguous = np.zeros(r, bool)
    for k in range(r):
        for v in range(nv):
            xs = []
            for i in range(vol.starts[v], vol.starts[v] + vol.counts[v]):
                shift = mv0[i] + time[k] * (mv1[i] - mv0[i])
                lo = p0[i] + shift
                hi = e1[i] + shift if kind[i] == PRIM_BOX else e1[i]
                c, margin = _crossings(kind[i], lo, hi, e2[i], o[k], d[k])
                if margin < EDGE or any(abs(t - T_MIN) < EDGE for t, _ in c):
                    ambiguous[k] = True
                xs += [(t, f) for t, f in c if t > T_MIN]
            xs.sort()
            if len(xs) > 1 and xs[1][0] - xs[0][0] < EDGE * (1 + xs[0][0]):
                ambiguous[k] = True     # coincident crossings (mesh edges)
            if not xs:
                continue
            t1, front = xs[0]
            later = [t for t, _ in xs if t > t1]
            entry, exit_t = (t1, later[0] if later else np.inf) if front \
                else (T_MIN, t1)
            if not np.isfinite(exit_t):
                continue
            dist = -np.log(u[k, v]) / dens[v]
            if abs(dist - (exit_t - entry)) < EDGE * (1 + dist):
                ambiguous[k] = True
            if dist < exit_t - entry:
                cand[k, v] = entry + dist
    return cand, ambiguous


@pytest.mark.parametrize("name", list(BOUNDARIES))
def test_crossing_scan_matches_f64_reference(name):
    scene = rt.compile_scene(rt.group(BOUNDARIES[name]()))
    vol = scene.volumes
    rng = np.random.default_rng(len(name))
    r = 256
    o = rng.uniform(-3.5, 3.5, (r, 3))          # inside and outside
    d = rng.uniform(-2, 2, (r, 3)) - o * rng.uniform(0, 1, (r, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    time = rng.uniform(0, 1, r)
    u = rng.uniform(0.05, 1.0, (r, vol.n_volumes))
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    t_cand, valid = volume_candidates(vol, f32(o), f32(d), f32(time),
                                      jnp.full((r,), T_MIN, jnp.float32),
                                      f32(u))
    t_cand, valid = np.asarray(t_cand), np.asarray(valid)
    ref, amb = _reference(vol, o, d, time, u.astype(np.float32))
    ok = ~amb
    assert ok.mean() > 0.8
    assert np.isfinite(ref[ok]).sum() > r // 10, "too few scatter events"
    np.testing.assert_array_equal(valid[ok], np.isfinite(ref[ok]))
    fin = np.isfinite(ref) & ok[:, None]
    np.testing.assert_allclose(t_cand[fin], ref[fin], rtol=1e-4, atol=1e-4)
