"""Nearest-hit engines against a per-ray float64 numpy brute force.

Both XLA engines — the dense [R, C] scan and the per-lane threaded-BVH
loop (ops/intersect.py:nearest_hit_t) — must pick the same nearest hit
as an independent f64 implementation of the reference primitives
(sphere Geometry.hs:58-92, planeShape Geometry.hs:108-176, box slab test,
motion Geometry.hs:447-456), over every primitive kind, static and
moving, and on padded kind-segmented tables.  Rays whose f64 answer sits
within rounding of a decision (membership edge, grazing sphere, two
near-equal candidates) are not held to the winner index.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import raytrace_tpu as rt
from raytrace_tpu.ops.intersect import nearest_hit_t
from raytrace_tpu.scene.types import (
    PRIM_BOX, PRIM_PARALLELOGRAM, PRIM_SPHERE, PRIM_TRIANGLE,
)

T_MIN = 1e-3
EDGE = 1e-4          # f64 decision margin below which a ray is ambiguous
KINDS = ("sphere", "parallelogram", "triangle", "box", "mixed")


def _blocks(kind, n, rng):
    out = []
    for _ in range(n):
        k = rng.choice(["sphere", "parallelogram", "triangle", "box"]) \
            if kind == "mixed" else kind
        c = rng.uniform(-4, 4, 3)
        if k == "sphere":
            out.append(rt.sphere(c, rng.uniform(0.3, 0.9)))
        elif k == "parallelogram":
            out.append(rt.parallelogram(c, rng.uniform(-1.5, 1.5, 3),
                                        rng.uniform(-1.5, 1.5, 3)))
        elif k == "triangle":
            out.append(rt.triangle(c, c + rng.uniform(-3, 3, 3),
                                   c + rng.uniform(-3, 3, 3)))
        else:
            out.append(rt.cuboid(c, c + rng.uniform(0.3, 1.5, 3)))
    return out


def _scene(kind, motion, accel, n, seed):
    rng = np.random.default_rng(seed)
    geom = rt.group(_blocks(kind, n, rng))
    if motion:
        geom = rt.moving([0, 0, 0], rng.uniform(-1, 1, 3), geom)
    world = rt.with_material(rt.lambertian(rt.constant_texture(0.5)), geom)
    return rt.compile_scene(world, accel=accel)


def _rays(n, seed):
    rng = np.random.default_rng(seed + 100)
    o = rng.uniform(-9, 9, (n, 3))
    target = rng.uniform(-4, 4, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, rng.uniform(0, 1, n)


def _ref_nearest(prims, o, d, time):
    """f64 nearest hit per ray: (t, idx, ambiguous)."""
    kind = np.asarray(prims.kind)
    p0, e1, e2, mv0, mv1 = (np.asarray(x, np.float64) for x in (
        prims.p0, prims.e1, prims.e2, prims.mv0, prims.mv1))
    r = o.shape[0]
    best_t = np.full(r, np.inf)
    best_i = np.full(r, -1)
    ambiguous = np.zeros(r, bool)
    for k in range(r):
        # each row moved by its own motion at the ray's time
        orel = o[k] - (mv0 + time[k] * (mv1 - mv0))             # [N, 3]
        cands = []                                  # (t, prim)
        for i in range(kind.shape[0]):
            roots, margin = [], np.inf
            if kind[i] == PRIM_SPHERE:
                oc = p0[i] - orel[i]
                h = d[k] @ oc
                c = oc @ oc - e1[i, 0] ** 2
                disc = h * h - c
                margin = abs(disc) / (h * h + abs(c) + 1e-12)
                if disc >= 0:
                    roots = [h - np.sqrt(disc), h + np.sqrt(disc)]
            elif kind[i] in (PRIM_PARALLELOGRAM, PRIM_TRIANGLE):
                n = np.cross(e1[i], e2[i])
                nn = n / np.linalg.norm(n)
                den = nn @ d[k]
                if abs(den) > 1e-8:
                    t = nn @ (p0[i] - orel[i]) / den
                    p = orel[i] + t * d[k] - p0[i]
                    ns = n / (n @ n)
                    a = ns @ np.cross(p, e2[i])
                    b = ns @ np.cross(e1[i], p)
                    if kind[i] == PRIM_PARALLELOGRAM:
                        edges = [a, 1 - a, b, 1 - b]
                    else:
                        edges = [a, b, 1 - a - b]
                    margin = min(abs(x) for x in edges)
                    if min(edges) >= 0:
                        roots = [t]
            elif kind[i] == PRIM_BOX:
                lo, hi = p0[i] - orel[i], e1[i] - orel[i]
                with np.errstate(divide="ignore", invalid="ignore"):
                    t0, t1 = lo / d[k], hi / d[k]
                tn = np.max(np.minimum(t0, t1))
                tf = np.min(np.maximum(t0, t1))
                margin = abs(tf - tn) / (abs(tn) + 1.0)
                if tn <= tf:
                    roots = [tn, tf]
            sel = [t for t in roots if T_MIN < t]
            if roots and (margin < EDGE or any(abs(t - T_MIN) < EDGE
                                               for t in roots)):
                ambiguous[k] = True
            if sel:
                cands.append((sel[0], i))
        if cands:
            cands.sort()
            best_t[k], best_i[k] = cands[0]
            if len(cands) > 1 and cands[1][0] - cands[0][0] < EDGE * (
                    1 + cands[0][0]):
                ambiguous[k] = True
    return best_t, best_i, ambiguous


def _check(scene, n_rays, seed):
    o, d, time = _rays(n_rays, seed)
    p = scene.prims
    t, idx = nearest_hit_t(
        p, scene.bvh, jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
        jnp.asarray(time, jnp.float32), jnp.full((n_rays,), T_MIN),
        jnp.full((n_rays,), jnp.inf))
    t, idx = np.asarray(t), np.asarray(idx)
    ref_t, ref_i, amb = _ref_nearest(p, o, d, time)
    ok = ~amb
    assert ok.mean() > 0.8, "too many ambiguous rays for a meaningful test"
    hit = np.isfinite(ref_t) & ok
    assert hit.sum() > n_rays // 5, "too few hits for a meaningful test"
    np.testing.assert_array_equal(np.isfinite(t)[ok], np.isfinite(ref_t)[ok])
    np.testing.assert_allclose(t[hit], ref_t[hit], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(idx[hit], ref_i[hit])


@pytest.mark.parametrize("accel", ["dense", "bvh"])
@pytest.mark.parametrize("motion", [False, True], ids=["static", "motion"])
@pytest.mark.parametrize("kind", KINDS)
def test_engine_matches_f64_reference(kind, motion, accel):
    scene = _scene(kind, motion, accel, n=40, seed=KINDS.index(kind))
    assert (scene.bvh is not None) == (accel == "bvh")
    assert scene.prims.has_motion == motion
    _check(scene, 256, seed=KINDS.index(kind) + 10 * motion)


@pytest.mark.parametrize("motion", [False, True], ids=["static", "motion"])
def test_dense_segmented_padded_table(motion):
    """>= 65 rows: kind-major segments, each padded to 64-row clusters
    with never-hit PRIM_PAD rows inside the table."""
    scene = _scene("mixed", motion, "dense", n=150, seed=7)
    p = scene.prims
    assert p.kind_segments is not None
    assert (np.asarray(p.kind) == -1).any()
    _check(scene, 256, seed=20 + motion)
