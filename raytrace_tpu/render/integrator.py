"""Wavefront path-tracing integrator.

The reference integrator is a lazy recursion per ray (``rayColor``,
Ray.hs:174-224).  The array design (SURVEY.md §3.2, BASELINE
north-star) converts it to an *iterative wavefront*: a buffer of live rays
advances through bounded bounce iterations carrying
``(radiance, throughput, alive)`` — each recursion level
``emitted + weight * child`` becomes ``radiance += throughput * emitted;
throughput *= weight``.  All material logic is evaluated branchlessly with
masked selects over integer material tags; there is no per-ray control
flow anywhere.

Two drivers share one bounce body:

* :func:`trace` — fixed ray batch, ``while_loop`` until all paths die
  (or a bounded ``scan`` in differentiable mode).
* :func:`trace_wavefront` — *persistent* wavefront with ray regeneration:
  dead lanes are refilled with fresh (pixel, sample) work from a global
  queue every iteration, so vector-lane occupancy stays ~100% regardless
  of path-length variance — the array answer to "ray compaction"
  (SURVEY.md §5 long-context).  Finished paths scatter-add into the image
  accumulator at death.

Randomness: each lane derives one key per bounce, and all the bounce's
draws come from a single vectorized uniform block (counter-hash keyed on
(pixel, sample, depth, column)); sampling transforms are branchless
(core/rng.py).

Importance-sampled redirection with MIS mixture pdfs follows
Ray.hs:112-151 and 187-224 exactly: CDF target selection, mixture pdf
``remProb * pdf_base + sum probs_i * t_i^2 / |cross_i . dir|``, and the
reference's pdf<=0 path kill (Ray.hs:198).

Differentiability: sampled directions and discrete choices are detached;
the mixture-pdf *denominator* is wrapped in ``stop_gradient`` so gradients
flow through BRDF/throughput factors only (reparameterized/detached
sampling per the BASELINE north-star).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import rng
from ..core.vecmath import (
    DTYPE, matmul, normalize, reflect, refract, vdot, vdot0,
)
from ..materials.materials import (
    MAT_ANISOTROPIC, MAT_DIELECTRIC, MAT_LAMBERTIAN, MAT_LIGHT, MAT_LOMMEL,
    MAT_METAL, MAT_MIRROR, MAT_PITCH_BLACK, MAT_TRANSPARENT,
)
from ..ops.intersect import INF, make_hit_record, nearest_hit_t
from ..scene.types import Scene
from ..textures.textures import eval_texture
from .camera import CameraSettings, camera_frame, generate_ray_components
from .volumes import volume_candidates

# uniform-block column layout for one bounce
_U_SPEC0 = 0      # metal fuzz unit vector (z)
_U_SPEC1 = 1      # metal fuzz unit vector (phi)
_U_DIELECTRIC = 2
_U_DIR0 = 3       # diffuse unit vector (z)
_U_DIR1 = 4       # diffuse unit vector (phi)
_U_CHOICE = 5     # redirect target CDF draw
_U_TGT_I = 6
_U_TGT_J = 7
_N_BASE_U = 8     # + one column per volume

LANE_ALIGN = 128  # lane-pool alignment (pixel blocks of the sharded driver)


def n_bounce_uniforms(scene: Scene) -> int:
    nv = scene.volumes.n_volumes if scene.volumes is not None else 0
    return _N_BASE_U + nv


def _n_scan_prims(prims) -> int:
    """Rows that can hold real primitives: unsegmented tables have all
    pad rows trailing, so the true count skips them; kind-segmented
    tables pad inside each segment, so all rows count."""
    if prims.kind_segments is None and 0 < prims.n < prims.kind.shape[0]:
        return prims.n
    return prims.kind.shape[0]


def _eval_redirect_pdf(s: CameraSettings, point, direction):
    """Sum of per-target pdf terms for a direction: ``t^2 / |cross . dir|``
    if the ray from ``point`` hits the target parallelogram, else 0
    (Ray.hs:199-204).  Targets are few and static — vectorized over them.
    """
    if s.n_redirect == 0:
        return jnp.zeros(point.shape[0], DTYPE)
    q = s.redirect_q            # [T,3]
    u = s.redirect_u
    v = s.redirect_v
    cp = jnp.cross(u, v)        # [T,3]
    cp_sq = jnp.maximum(vdot0(cp, cp), 1e-30)
    n_unit = cp * jax.lax.rsqrt(cp_sq)[:, None]
    n_s = cp / cp_sq[:, None]
    w_a = jnp.cross(v, n_s)
    w_b = jnp.cross(n_s, u)

    # private parallelogram intersector (Ray.hs:112-118), interval (0, inf)
    denom = matmul(direction, n_unit.T)                       # [R,T]
    denom_safe = jnp.where(jnp.abs(denom) > 1e-8, denom, 1.0)
    t = ((q * n_unit).sum(-1)[None, :] - matmul(point, n_unit.T)) \
        / denom_safe
    p_rel_dot = lambda w: (matmul(point, w.T) - (q * w).sum(-1)[None, :]
                           + t * matmul(direction, w.T))
    a = p_rel_dot(w_a)
    b = p_rel_dot(w_b)
    hit = ((jnp.abs(denom) > 1e-8) & (t > 0.0)
           & (0.0 <= a) & (a <= 1.0) & (0.0 <= b) & (b <= 1.0))
    cross_dot = jnp.abs(matmul(direction, cp.T))
    pdf_each = jnp.where(hit, t * t / jnp.maximum(cross_dot, 1e-12), 0.0)
    return matmul(pdf_each, s.redirect_prob)


def _henyey_greenstein(g, mu):
    """HG phase (x albedo x 4 pi in the reference contract, Material.hs:124-129)."""
    g2 = g * g
    return (1.0 - g2) / jnp.power(jnp.maximum(1.0 + g2 - 2.0 * g * mu, 1e-12), 1.5)


def _surface_hit(scene: Scene, s: CameraSettings, o, d, time,
                 diff: bool = False):
    """Nearest surface hit + record fields: ``(t, idx, normal, front, uv,
    mat)`` with ``t = +inf`` on miss.

    ``diff=True`` routes through the custom-VJP wrapper (winner-only
    analytic backward; ops/diff_intersect.py)."""
    r = o.shape[0]

    def _maybe_merge(res):
        # spheres under arbitrary affines live in their own tiny buffer,
        # intersected separately and merged here (all paths incl. diff —
        # plain differentiable ops, so ellipsoid params get gradients)
        if scene.ellipsoids is None:
            return res
        from ..ops.ellipsoid import merge_ellipsoid_hits
        return merge_ellipsoid_hits(scene.ellipsoids, o, d, time,
                                    float(s.t_min), *res)

    if diff:
        from ..ops.diff_intersect import make_diff_surface_hit
        p = scene.prims
        hit_fn = make_diff_surface_hit(p.has_motion, float(s.t_min),
                                       has_box=p.has_box,
                                       sphere_rots=p.sphere_rots)
        ints_f = (p.kind.astype(DTYPE), p.mat.astype(DTYPE))
        return _maybe_merge(hit_fn(
            (p.p0, p.e1, p.e2, p.uvs, p.mv0, p.mv1), ints_f, o, d, time))
    tmin = jnp.full((r,), s.t_min, DTYPE)
    tmax = jnp.full((r,), INF, DTYPE)
    t_srf, idx = nearest_hit_t(scene.prims, scene.bvh, o, d, time, tmin, tmax)
    rec = make_hit_record(scene.prims, idx, o, d, time,
                          jnp.where(jnp.isfinite(t_srf), t_srf, 1.0))
    return _maybe_merge(
        (t_srf, idx, rec.normal, rec.front, rec.uv, rec.mat))


def bounce(scene: Scene, s: CameraSettings, o, d, time, uniforms,
           radiance, throughput, alive, diff: bool = False):
    """Advance every live lane by one bounce.

    ``uniforms[R, n_bounce_uniforms]`` supplies all randomness.  Returns
    ``(o', d', radiance', throughput', alive', died_now)``.  The three
    stages carry the trace spans ``intersect``, ``volume_crossing`` and
    ``shade``.
    """
    r = o.shape[0]
    has_targets = s.n_redirect > 0
    if has_targets:
        rem_prob = 1.0 - jnp.sum(s.redirect_prob)
        cdf = jnp.cumsum(s.redirect_prob)

    # --- intersect: surfaces + media (global argmin; SURVEY.md §3.3) ---
    with jax.named_scope("intersect"):
        if not diff:
            # park dead lanes' stale rays far outside the scene: the BVH
            # loop runs until its slowest lane exits, and a parked ray
            # misses the root box at once
            o = jnp.where(alive[:, None], o, jnp.float32(3e18))
        t_srf, idx, normal, front, uv, mat_id = _surface_hit(
            scene, s, o, d, time, diff=diff)

    if scene.volumes is not None:
        tmin = jnp.full((r,), s.t_min, DTYPE)
        nv = scene.volumes.n_volumes
        u_sc = uniforms[:, _N_BASE_U:_N_BASE_U + nv]
        with jax.named_scope("volume_crossing"):
            if diff:
                t_vol, _, seg_entry, seg_exit, seg_has = volume_candidates(
                    scene.volumes, o, d, time, tmin, u_sc,
                    with_segments=True)
            else:
                t_vol, _ = volume_candidates(scene.volumes, o, d, time,
                                             tmin, u_sc)
        # winner volume's material via a static fold over the (few)
        # volumes
        t_med = jnp.full((r,), INF, DTYPE)
        vol_mat = jnp.zeros((r,), mat_id.dtype)
        vol_win = jnp.full((r,), -1, jnp.int32)
        for v in range(nv):
            better = t_vol[:, v] < t_med
            t_med = jnp.where(better, t_vol[:, v], t_med)
            vol_mat = jnp.where(better, scene.volumes.mat[v], vol_mat)
            vol_win = jnp.where(better, v, vol_win)
        in_medium = t_med < t_srf
        t_hit = jnp.where(in_medium, t_med, t_srf)
        if diff:
            # --- density gradients: score-function (likelihood-ratio)
            # weight, value exactly 1 (Geometry.hs:298-330 density is a
            # first-class scene parameter; the reparameterized position
            # gradient vanishes under detached sampling, so the event
            # probability carries the gradient instead).  Per volume:
            #   scattered here: pdf = rho * exp(-rho * s)
            #   passed through L of it: P = exp(-rho * L)
            # w = exp(logp - sg(logp)) == 1.0 multiplies throughput, so
            # d loss/d rho = E[loss * d logp/d rho] — the standard
            # unbiased estimator; u draws stay detached.
            # All lengths are DETACHED — only the densities are attached
            # in logp, so the weight's gradient is purely d logp/d rho
            # (geometry keeps its reparameterized path through t_hit).
            _sg = jax.lax.stop_gradient
            t_evt = _sg(jnp.where(jnp.isfinite(t_hit), t_hit,
                                  jnp.float32(3e18)))
            logp = jnp.zeros((r,), DTYPE)
            for v in range(nv):
                rho = scene.volumes.density[v]
                scat_v = in_medium & (vol_win == v) & alive
                entry_v = _sg(seg_entry[:, v])
                exit_v = _sg(seg_exit[:, v])
                has_v = seg_has[:, v] & alive
                # finite masked lengths: INF in an unselected where-branch
                # still poisons the VJP (0 * inf = NaN)
                seg_len = jnp.clip(jnp.minimum(t_evt, exit_v) - entry_v,
                                   0.0, None)
                seg_len = jnp.where(has_v & jnp.isfinite(seg_len),
                                    seg_len, 0.0)
                s_v = jnp.clip(_sg(t_med) - entry_v, 0.0, None)
                s_v = jnp.where(scat_v & jnp.isfinite(s_v), s_v, 0.0)
                lf = jnp.where(
                    scat_v, jnp.log(jnp.maximum(rho, 1e-20)) - rho * s_v,
                    jnp.where(has_v, -rho * seg_len, 0.0))
                logp = logp + lf
            w_score = jnp.exp(logp - _sg(logp))
            throughput = throughput * w_score[:, None]
    else:
        in_medium = jnp.zeros((r,), bool)
        t_hit = t_srf

    with jax.named_scope("shade"):
        hit_any = jnp.isfinite(t_hit)

        # --- miss: background (Ray.hs:179) ---
        bg = s.background(o, d).astype(DTYPE)
        miss = alive & ~hit_any
        radiance = radiance + jnp.where(miss[:, None], throughput * bg,
                                        0.0)

        # --- hit point; medium overrides (arbitrary normal/uv,
        # Geometry.hs:320-326); t_safe keeps grads NaN-free on miss
        t_safe = jnp.where(hit_any, t_hit, 1.0)
        point = o + t_safe[:, None] * d
        if scene.volumes is not None:
            med = in_medium[:, None]
            normal = jnp.where(med, -d, normal)
            front = jnp.where(in_medium, True, front)
            uv = jnp.where(med, 0.0, uv)
            mat_id = jnp.where(in_medium, vol_mat, mat_id)

        kind = scene.materials.kind[mat_id]
        tex_id = scene.materials.tex[mat_id]
        # One-hot gathers of the float tables (core/vecmath.py:
        # gather_rows).  The [R, T] one-hot is capped at 64 rows: scenes
        # interning hundreds of distinct constant colors (demo1: 460
        # materials) would build gigabyte one-hots, so large tables keep
        # the direct gather in the non-diff path.
        n_mats = scene.materials.kind.shape[0]
        use_onehot = diff or n_mats <= 64
        if use_onehot:
            from ..core.vecmath import gather_rows, onehot_rows
            oh_m = onehot_rows(mat_id, n_mats)
            param = gather_rows(oh_m, scene.materials.param)
        else:
            param = scene.materials.param[mat_id]
        tex_onehot = diff or scene.textures.kind.shape[0] <= 64
        albedo = eval_texture(scene.textures, tex_id, point, uv,
                              onehot=tex_onehot)

        live_hit = alive & hit_any

        # --- emitted (Ray.hs:181-183): only lightSource emits ---
        emitted = jnp.where((kind == MAT_LIGHT)[:, None], albedo, 0.0)
        radiance = radiance + jnp.where(live_hit[:, None],
                                        throughput * emitted, 0.0)

        # --- behaviour classes ---
        is_absorb = (kind == MAT_LIGHT) | (kind == MAT_PITCH_BLACK)
        is_hemi = (kind == MAT_LAMBERTIAN) | (kind == MAT_LOMMEL)
        is_spec = (kind == MAT_MIRROR) | (kind == MAT_METAL) | \
                  (kind == MAT_DIELECTRIC) | (kind == MAT_TRANSPARENT)

        # --- specular family (Material.hs:65-112) ---
        refl = reflect(normal, d)
        fuzz_u = rng.unit_vector_from_uniforms(uniforms[:, _U_SPEC0],
                                               uniforms[:, _U_SPEC1])
        metal_dir = refl + param[:, None] * fuzz_u
        metal_ok = vdot0(metal_dir, normal) > 0.0          # Material.hs:76-77
        metal_dir = normalize(metal_dir)

        ior = jnp.maximum(param, 1e-6)
        ior_ratio = jnp.where(front, 1.0 / ior, ior)       # Material.hs:90
        cos_t = jnp.minimum(1.0, vdot0(normal, -d))
        sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
        cannot = ior_ratio * sin_t > 1.0
        r0 = (1.0 - ior_ratio) / (1.0 + ior_ratio)
        r0 = r0 * r0
        schlick = r0 + (1.0 - r0) * jnp.power(1.0 - cos_t, 5.0)
        di_reflect = cannot | (uniforms[:, _U_DIELECTRIC] < schlick)
        di_dir = jnp.where(di_reflect[:, None], refl,
                           refract(ior_ratio, cos_t, normal, d))

        spec_dir = jnp.where((kind == MAT_MIRROR)[:, None], refl, d)
        spec_dir = jnp.where((kind == MAT_METAL)[:, None], metal_dir,
                             spec_dir)
        spec_dir = jnp.where((kind == MAT_DIELECTRIC)[:, None], di_dir,
                             spec_dir)
        spec_att = jnp.where((kind == MAT_DIELECTRIC)[:, None],
                             jnp.ones_like(albedo), albedo)
        spec_dead = (kind == MAT_METAL) & ~metal_ok

        # --- diffuse family with redirection (Ray.hs:187-224) ---
        unit_u = rng.unit_vector_from_uniforms(uniforms[:, _U_DIR0],
                                               uniforms[:, _U_DIR1])
        # cosine-weighted (Ray.hs:191-192)
        cos_dir = normalize(normal + unit_u)
        base_dir = jnp.where(is_hemi[:, None], cos_dir, unit_u)

        if has_targets:
            x_t = uniforms[:, _U_CHOICE]
            # CDF threshold selection (Ray.hs:148-151): first target whose
            # cumulative prob exceeds x; none -> base sample.
            t_sel = jnp.sum(
                (x_t[:, None] >= cdf[None, :]).astype(jnp.int32), 1)
            use_target = t_sel < s.n_redirect
            ti = jnp.minimum(t_sel, s.n_redirect - 1)
            light_pt = (s.redirect_q[ti]
                        + uniforms[:, _U_TGT_I, None] * s.redirect_u[ti]
                        + uniforms[:, _U_TGT_J, None] * s.redirect_v[ti])
            tgt_dir = normalize(light_pt - point)
            diff_dir = jnp.where(use_target[:, None], tgt_dir, base_dir)
        else:
            diff_dir = base_dir
        diff_dir = jax.lax.stop_gradient(diff_dir)

        mu1 = vdot0(diff_dir, normal)
        pdf_base = jnp.where(is_hemi, mu1 / jnp.pi, 0.25 / jnp.pi)
        hemi_dead = is_hemi & (pdf_base <= 0.0)            # Ray.hs:198

        if has_targets:
            pdf_t = _eval_redirect_pdf(s, point, diff_dir)
            pdf_mix = rem_prob * pdf_base + pdf_t
        else:
            pdf_mix = pdf_base
        # detached sampling density; BRDF numerator stays differentiable
        pdf_mix = jax.lax.stop_gradient(jnp.maximum(pdf_mix, 1e-12))

        mu0 = -vdot0(d, normal)
        lommel = 0.25 / jnp.maximum(mu0 + mu1, 1e-8)
        hg = _henyey_greenstein(param, vdot0(d, diff_dir))
        brdf_factor = jnp.ones((r,), DTYPE)
        brdf_factor = jnp.where(kind == MAT_LOMMEL, lommel, brdf_factor)
        brdf_factor = jnp.where(kind == MAT_ANISOTROPIC, hg, brdf_factor)
        diff_w = albedo * (brdf_factor * pdf_base / pdf_mix)[:, None]

        # --- combine ---
        new_dir = jnp.where(is_spec[:, None], spec_dir, diff_dir)
        weight = jnp.where(is_spec[:, None], spec_att, diff_w)
        next_alive = live_hit & ~is_absorb & ~spec_dead & ~hemi_dead

        throughput = jnp.where(next_alive[:, None], throughput * weight,
                               throughput)
        o_new = jnp.where(next_alive[:, None], point, o)
        d_new = jnp.where(next_alive[:, None], new_dir, d)
        died_now = alive & ~next_alive
        return o_new, d_new, radiance, throughput, next_alive, died_now


def _russian_roulette(s: CameraSettings, u_rr, depth, thr_tuple, alive,
                      died, detach: bool = False):
    """Opt-in Russian roulette (NOT in the reference; unbiased): from
    ``depth >= s.rr_depth`` a path survives with probability
    ``clamp(max(throughput), rr_min, 1)`` and survivors' throughput is
    divided by it.  Cuts the deep-path tail that dominates wavefront
    iteration counts at max_depth=50 (lane occupancy 0.4 -> ~0.9).

    ``thr_tuple`` is an (r, g, b) tuple of [R] arrays. Returns
    (thr', alive', died').  ``detach=True`` stops gradients through the
    survival probability (detached sampling, like the MIS denominators).
    """
    thr_max = jnp.maximum(thr_tuple[0],
                          jnp.maximum(thr_tuple[1], thr_tuple[2]))
    p = jnp.clip(thr_max, s.rr_min, 1.0)
    if detach:
        p = jax.lax.stop_gradient(p)
    do = depth >= s.rr_depth
    kill = do & (u_rr >= p)
    scale = jnp.where(do & ~kill, 1.0 / p, 1.0)
    thr = tuple(t * scale for t in thr_tuple)
    rr_kill = alive & kill
    return thr, alive & ~kill, died | rr_kill


def _bounce_soa(scene: Scene, s: CameraSettings, comps, uniforms, rad,
                thr, alive, diff: bool = False):
    """:func:`bounce` on the drivers' structure-of-arrays lane state:
    ``comps = (ox, oy, oz, dx, dy, dz, time)``, ``rad``/``thr`` (r, g, b)
    tuples of [R] arrays.  Returns ``(comps', rad', thr', alive', died)``.
    """
    o = jnp.stack(comps[0:3], axis=-1)
    d = jnp.stack(comps[3:6], axis=-1)
    o, d, radiance, throughput, alive, died = bounce(
        scene, s, o, d, comps[6], uniforms, jnp.stack(rad, axis=-1),
        jnp.stack(thr, axis=-1), alive, diff=diff)
    comps = (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], comps[6])
    rad = (radiance[:, 0], radiance[:, 1], radiance[:, 2])
    thr = (throughput[:, 0], throughput[:, 1], throughput[:, 2])
    return comps, rad, thr, alive, died


def trace(scene: Scene, s: CameraSettings, o, d, time, keys,
          differentiable: bool = False):
    """Trace a fixed batch of rays to completion; returns radiance [R, 3].

    ``keys`` are per-ray typed RNG keys (shard-invariant, see core/rng.py).

    ``differentiable=True`` drives the same bounce body with a bounded
    ``lax.scan`` (reverse-mode AD cannot cross ``while_loop``); each bounce
    is rematerialized under ``jax.checkpoint``.
    """
    r = o.shape[0]
    n_u = n_bounce_uniforms(scene)

    def body(state):
        depth, o, d, radiance, throughput, alive, time = state
        dkeys = rng.mix_depth(keys, depth)
        uniforms = rng.uniform_block(dkeys, n_u + 1)
        o, d, radiance, throughput, alive, _ = bounce(
            scene, s, o, d, time, uniforms, radiance, throughput, alive,
            diff=differentiable)
        if s.rr_depth is not None:
            thr_t = (throughput[:, 0], throughput[:, 1], throughput[:, 2])
            thr_t, alive, _ = _russian_roulette(
                s, uniforms[:, n_u], depth + 1, thr_t, alive,
                jnp.zeros_like(alive), detach=differentiable)
            throughput = jnp.stack(thr_t, axis=-1)
        return depth + 1, o, d, radiance, throughput, alive, time

    def cond(state):
        depth = state[0]
        alive = state[5]
        return (depth < s.max_depth) & jnp.any(alive)

    state = (
        jnp.zeros((), jnp.int32), o, d, jnp.zeros((r, 3), DTYPE),
        jnp.ones((r, 3), DTYPE), jnp.ones((r,), bool), time,
    )
    if differentiable:
        ckpt_body = jax.checkpoint(body)

        def scan_body(st, _):
            return ckpt_body(st), None

        state, _ = jax.lax.scan(scan_body, state, None, length=s.max_depth)
    else:
        state = jax.lax.while_loop(cond, body, state)
    return state[3]


def trace_wavefront(scene: Scene, s: CameraSettings, base_key, n_pix: int,
                    spp: int, n_lanes: int, acc=None, sample_offset: int = 0,
                    with_stats: bool = False):
    """Persistent wavefront: render ``n_pix * spp`` paths with a fixed pool
    of ``n_lanes`` lanes, regenerating dead lanes from the work queue every
    iteration.  Returns the [n_pix, 3] radiance *sum* over samples (divide
    by spp for the image); pass ``acc`` to continue accumulating
    (progressive rendering / checkpoint-resume).

    Work item w maps to (pixel = w % n_pix, sample = w // n_pix); RNG keys
    derive from those absolute coordinates, so the image is independent of
    n_lanes, batching, and device layout.
    """
    total_work = n_pix * spp
    n_u = n_bounce_uniforms(scene)
    frame = camera_frame(s)
    if acc is None:
        acc = jnp.zeros((n_pix, 3), DTYPE)
    lanes = min(n_lanes, -(-total_work // 128) * 128)

    def body(state):
        (acc_r, acc_g, acc_b, next_w, comps, rad, thr,
         alive, pixel, sample, depth, keys, iters, segments) = state

        # --- regenerate dead lanes from the queue ---
        dead = ~alive
        rank = jnp.cumsum(dead.astype(jnp.int32)) - dead.astype(jnp.int32)
        wi = next_w + rank
        can = dead & (wi < total_work)
        can_f = jnp.where(can, 1.0, 0.0)
        new_pixel = (wi % n_pix).astype(jnp.int32)
        new_sample = (wi // n_pix).astype(jnp.int32) + sample_offset
        nk = rng.ray_keys_fast(base_key, new_pixel, new_sample)
        keys = jax.random.wrap_key_data(jnp.where(
            can[:, None], jax.random.key_data(nk),
            jax.random.key_data(keys)))
        rad = tuple(r * (1.0 - can_f) for r in rad)
        thr = tuple(jnp.where(can, 1.0, t) for t in thr)
        pixel = jnp.where(can, new_pixel, pixel)
        sample = jnp.where(can, new_sample, sample)
        depth = jnp.where(can, 0, depth)
        alive = alive | can
        next_w = next_w + jnp.sum(can.astype(jnp.int32))

        # --- one uniform block per iteration: bounce draws + (for lanes
        # regenerated this iteration, at depth 0) camera draws + RR ---
        dkeys = rng.mix_depth(keys, depth)
        uniforms = rng.uniform_block(dkeys, n_u + 6)
        new_comps = generate_ray_components(s, frame, pixel,
                                            uniforms[:, n_u:n_u + 5])
        comps = tuple(jnp.where(can, nc, c)
                      for nc, c in zip(new_comps, comps))

        comps, rad, thr, alive, died = _bounce_soa(
            scene, s, comps, uniforms, rad, thr, alive)
        depth = depth + 1
        # depth cap kills lanes (reference depth<=0 -> black, Ray.hs:176)
        capped = alive & (depth >= s.max_depth)
        died = died | capped
        alive = alive & ~capped
        if s.rr_depth is not None:
            thr, alive, died = _russian_roulette(
                s, uniforms[:, n_u + 5], depth, thr, alive, died)

        # --- flush finished paths into the accumulator ---
        died_f = jnp.where(died, 1.0, 0.0)
        acc_r = acc_r.at[pixel].add(rad[0] * died_f, mode="drop")
        acc_g = acc_g.at[pixel].add(rad[1] * died_f, mode="drop")
        acc_b = acc_b.at[pixel].add(rad[2] * died_f, mode="drop")

        segments = segments + jnp.sum((alive | died).astype(jnp.int32))
        return (acc_r, acc_g, acc_b, next_w, comps, rad, thr,
                alive, pixel, sample, depth, keys, iters + 1, segments)

    def cond(state):
        next_w = state[3]
        alive = state[7]
        return (next_w < total_work) | jnp.any(alive)

    z1 = jnp.zeros((lanes,), DTYPE)
    o1 = jnp.ones((lanes,), DTYPE)
    init_keys = rng.ray_keys_fast(base_key, jnp.zeros(lanes, jnp.int32),
                                  jnp.zeros(lanes, jnp.int32))
    zw = jnp.zeros((n_pix,), DTYPE)
    state = (
        zw, zw, zw, jnp.zeros((), jnp.int32),
        (z1, z1, z1, z1, z1, o1, z1),       # o, d (dummy unit z), time
        (z1, z1, z1), (o1, o1, o1),         # radiance, throughput
        jnp.zeros((lanes,), bool),
        jnp.zeros((lanes,), jnp.int32), jnp.zeros((lanes,), jnp.int32),
        jnp.zeros((lanes,), jnp.int32), init_keys,
        jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
    )
    state = jax.lax.while_loop(cond, body, state)
    acc_out = acc + jnp.stack(state[0:3], axis=-1)
    if with_stats:
        return acc_out, dict(iterations=state[-2], segments=state[-1],
                             lanes=lanes)
    return acc_out


def _tile_maps(n_pix: int, width: int, lanes: int, tile_h: int = 8,
               tile_w: int = 128):
    """Tile-ordered pixel<->lane maps: consecutive lanes cover one 8x128
    screen tile instead of a full-width scanline strip, so freshly
    generated camera rays that sit next to each other in the lane order
    are also next to each other on screen.

    Returns (lane_to_pixel[lanes], pixel_to_lane[n_pix]) as np arrays.
    """
    import numpy as np
    p = np.arange(n_pix, dtype=np.int64)
    j, i = p // width, p % width
    n_tx = -(-width // tile_w)
    key = (((j // tile_h) * n_tx + (i // tile_w)) * (tile_h * tile_w)
           + (j % tile_h) * tile_w + (i % tile_w))
    order = np.argsort(key, kind="stable").astype(np.int32)  # lane -> pixel
    lane_to_pixel = np.full(lanes, n_pix - 1, np.int32)
    lane_to_pixel[:n_pix] = order
    pixel_to_lane = np.empty(n_pix, np.int32)
    pixel_to_lane[order] = np.arange(n_pix, dtype=np.int32)
    return lane_to_pixel, pixel_to_lane


def trace_wavefront_stationary(scene: Scene, s: CameraSettings, base_key,
                               n_pix: int, spp: int, acc=None,
                               sample_offset: int = 0,
                               with_stats: bool = False,
                               rotate_k: int = 1,
                               pixel_offset=0):
    """Pixel-stationary persistent wavefront: lane ``l`` owns pixel
    ``pixel_offset + l`` for the whole launch and traces its ``spp``
    samples sequentially.  ``pixel_offset`` lets a device render a
    contiguous pixel block of a larger image (parallel/sharding.py
    shard_map path); RNG keys use absolute pixel ids, so the image is
    identical however the blocks are cut.

    With stationary lanes the flush is a lane-indexed *masked add* — no
    scatter anywhere — at the price of some tail imbalance (lanes whose
    pixels have long paths finish last).

    ``rotate_k > 1`` (must divide ``spp``) rotates each lane through ``k``
    pixels — lane ``l`` serves lane-slot ``(l + c*stride) % lanes`` for
    samples in chunk ``c = sample // (spp/k)`` — so per-lane total work
    averages the path-length variance of ``k`` pixels.  The stride is
    about ``lanes / k``, so the ``k`` pixels are spread across the WHOLE
    image (sky lanes average with fog lanes — adjacent pixels have
    correlated path lengths and average nothing).  The flush stays
    scatter-free: contributions land at a per-chunk *fixed* lane shift,
    i.e. ``k`` masked ``jnp.roll`` adds, unscrambled once at the end.

    RNG keys derive from absolute (pixel, sample) exactly as in
    :func:`trace_wavefront`, so all schedulers and any ``rotate_k``
    produce the same samples.
    """
    lanes = -(-n_pix // LANE_ALIGN) * LANE_ALIGN
    k_rot = rotate_k if (rotate_k > 1 and spp % rotate_k == 0) else 1
    spp_k = spp // k_rot
    n_u = n_bounce_uniforms(scene)
    frame = camera_frame(s)
    if acc is None:
        acc = jnp.zeros((n_pix, 3), DTYPE)
    last_sample = sample_offset + spp - 1

    # rotation stride: ~lanes/k, rounded down to whole 4096-lane blocks,
    # spreads a lane's k pixels across the whole image.  Small lane pools
    # where the rounded stride degenerates (stride % lanes == 0 would
    # rotate by nothing) fall back to plain lanes/k.
    _BLK = 32 * LANE_ALIGN
    stride = max((lanes // max(k_rot, 1)) // _BLK * _BLK, _BLK)
    if k_rot > 1 and stride % lanes == 0:
        stride = max(lanes // k_rot, 1)

    lane_ids = jnp.arange(lanes, dtype=jnp.int32)

    if k_rot == 1:
        # padding lanes (>= n_pix) start exhausted
        init_sample = jnp.where(lane_ids < n_pix,
                                sample_offset - 1, last_sample + 1)
    else:
        # every lane works: padded slots are dummy pixels whose
        # contributions land at lane slots >= n_pix and are dropped at
        # the final unscramble (wasted work: (lanes-n_pix)*spp, <0.1%)
        init_sample = jnp.full((lanes,), sample_offset - 1, jnp.int32)

    def body(state):
        (acc_r, acc_g, acc_b, comps, rad, thr, alive, sample, depth, keys,
         iters, segments) = state

        # --- start this lane's next sample if idle ---
        can = ~alive & (sample < last_sample)
        can_f = jnp.where(can, 1.0, 0.0)
        sample = jnp.where(can, sample + 1, sample)
        if k_rot == 1:
            rot_c = None
            lane_pixel = pixel_offset + jnp.minimum(lane_ids, n_pix - 1)
        else:
            rot_c = ((sample - sample_offset) // spp_k).astype(jnp.int32)
            rot_c = jnp.clip(rot_c, 0, k_rot - 1)
            # lane l serves lane-slot (l + c*stride) % lanes; the k
            # possible lane->pixel maps are rolled constants, selected by
            # the per-lane chunk with a where-chain (no dynamic gather)
            maps = [pixel_offset + jnp.minimum(
                        (lane_ids + cc * stride) % lanes, n_pix - 1)
                    for cc in range(k_rot)]
            lane_pixel = maps[0]
            for cc in range(1, k_rot):
                lane_pixel = jnp.where(rot_c == cc, maps[cc], lane_pixel)
        nk = rng.ray_keys_fast(base_key, lane_pixel, sample)
        keys = jax.random.wrap_key_data(jnp.where(
            can[:, None], jax.random.key_data(nk),
            jax.random.key_data(keys)))
        rad = tuple(r * (1.0 - can_f) for r in rad)
        thr = tuple(jnp.where(can, 1.0, t) for t in thr)
        depth = jnp.where(can, 0, depth)
        alive = alive | can

        dkeys = rng.mix_depth(keys, depth)
        uniforms = rng.uniform_block(dkeys, n_u + 6)
        new_comps = generate_ray_components(s, frame, lane_pixel,
                                            uniforms[:, n_u:n_u + 5])
        comps = tuple(jnp.where(can, nc, c)
                      for nc, c in zip(new_comps, comps))

        comps, rad, thr, alive, died = _bounce_soa(
            scene, s, comps, uniforms, rad, thr, alive)
        depth = depth + 1
        capped = alive & (depth >= s.max_depth)
        died = died | capped
        alive = alive & ~capped
        if s.rr_depth is not None:
            thr, alive, died = _russian_roulette(
                s, uniforms[:, n_u + 5], depth, thr, alive, died)

        # --- flush: lane-indexed masked add (scatter-free) ---
        died_f = jnp.where(died, 1.0, 0.0)
        if k_rot == 1:
            acc_r = acc_r + rad[0] * died_f
            acc_g = acc_g + rad[1] * died_f
            acc_b = acc_b + rad[2] * died_f
        else:
            # lane l's chunk-c contribution lands at slot
            # (l + c*stride) % lanes — a fixed shift per chunk c: k
            # masked rolls per iteration
            for cc in range(k_rot):
                m = died_f * jnp.where(rot_c == cc, 1.0, 0.0)
                acc_r = acc_r + jnp.roll(rad[0] * m, cc * stride)
                acc_g = acc_g + jnp.roll(rad[1] * m, cc * stride)
                acc_b = acc_b + jnp.roll(rad[2] * m, cc * stride)

        segments = segments + jnp.sum((alive | died).astype(jnp.int32))
        return (acc_r, acc_g, acc_b, comps, rad, thr, alive, sample, depth,
                keys, iters + 1, segments)

    def cond(state):
        alive = state[6]
        sample = state[7]
        return jnp.any(alive | (sample < last_sample))

    z1 = jnp.zeros((lanes,), DTYPE)
    o1 = jnp.ones((lanes,), DTYPE)
    init_keys = rng.ray_keys_fast(base_key, jnp.zeros(lanes, jnp.int32),
                                  jnp.zeros(lanes, jnp.int32))
    state = (
        z1, z1, z1,
        (z1, z1, z1, z1, z1, o1, z1),
        (z1, z1, z1), (o1, o1, o1),
        jnp.zeros((lanes,), bool), init_sample.astype(jnp.int32),
        jnp.zeros((lanes,), jnp.int32), init_keys,
        jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
    )
    state = jax.lax.while_loop(cond, body, state)
    acc_out = acc + jnp.stack(state[0:3], axis=-1)[:n_pix]
    if with_stats:
        return acc_out, dict(iterations=state[-2], segments=state[-1],
                             lanes=lanes)
    return acc_out


# Mesh-scale scenes (at least this many primitive rows) take the
# ray-binned work-queue driver.  Not measured on the card yet (ROADMAP A7).
SORT_MIN_PRIMS = 8192
# origin-quantization cells per axis of the binning key
# (_spread3 handles up to 10-bit inputs)
_SORT_CELL = 256


def trace_wavefront_sorted(scene: Scene, s: CameraSettings, base_key,
                           n_pix: int, spp: int, acc=None,
                           sample_offset: int = 0,
                           with_stats: bool = False,
                           pixel_offset=0):
    """Ray-binned persistent WORK-QUEUE wavefront for mesh-scale scenes.

    Two ideas on top of :func:`trace_wavefront_stationary`:

    * **Ray binning** — the lane ORDER is re-sorted every iteration by
      (direction octant, quantized origin cell), so that lanes next to
      each other trace spatially coherent rays.  The permutation applies
      as ONE packed [C, R] take per dtype.
    * **Queue regeneration** — dead lanes pull fresh (pixel, sample)
      work items from a global counter instead of being bound to one
      pixel, so occupancy stays ~1 until the whole budget drains.  Work
      items enumerate pixels in 8x128 TILE order so freshly regenerated
      lanes (sorted together at the end) form coherent camera-ray rows.

    RNG keys are absolute (pixel, sample): the image equals the other
    drivers' bit-for-bit regardless of lane count or assignment order.
    """
    lanes = -(-n_pix // LANE_ALIGN) * LANE_ALIGN
    n_u = n_bounce_uniforms(scene)
    frame = camera_frame(s)
    if acc is None:
        acc = jnp.zeros((n_pix, 3), DTYPE)
    total_work = n_pix * spp

    # loose scene bbox for origin quantization (traced once per compile)
    p = scene.prims
    nn = _n_scan_prims(p)
    ext = jnp.abs(p.e1[:nn]) + jnp.abs(p.e2[:nn])
    blo = jnp.min(p.p0[:nn] - ext, axis=0)
    bhi = jnp.max(p.p0[:nn] + ext, axis=0)
    binv = 1.0 / jnp.maximum(bhi - blo, 1e-6)

    # work item w -> (pixel, sample): pixels enumerate in 8x128 tile
    # order so consecutive fresh lanes form one-tile camera bundles
    l2p_np, _ = _tile_maps(n_pix, s.image_width, n_pix)
    tile_l2p = jnp.asarray(l2p_np)

    def _spread3(x):
        # interleave 6 bits to every 3rd position (3-D Morton spread)
        x = (x | (x << 16)) & jnp.int32(0x030000FF)
        x = (x | (x << 8)) & jnp.int32(0x0300F00F)
        x = (x | (x << 4)) & jnp.int32(0x030C30C3)
        x = (x | (x << 2)) & jnp.int32(0x09249249)
        return x

    def sort_key(comps, alive):
        ox, oy, oz, dx, dy, dz, _ = comps
        oct_ = ((dx < 0).astype(jnp.int32) * 4
                + (dy < 0).astype(jnp.int32) * 2
                + (dz < 0).astype(jnp.int32))
        q = lambda o, k: jnp.clip(((o - blo[k]) * binv[k]
                                   * _SORT_CELL).astype(jnp.int32),
                                  0, _SORT_CELL - 1)
        cell = (_spread3(q(ox, 0)) | (_spread3(q(oy, 1)) << 1)
                | (_spread3(q(oz, 2)) << 2))
        live_key = oct_ * (_SORT_CELL ** 3) + cell
        # dead lanes sort together at the end (stable, so their queue
        # ranks are consecutive -> consecutive tile-ordered work items)
        dead_key = jnp.int32(1 << 25)
        return jnp.where(alive, live_key, dead_key)

    def rebin(state):
        # --- re-bin lanes (permutation travels with ALL lane state) ---
        (acc_r, acc_g, acc_b, next_w, comps, rad, thr, alive, lane_pixel,
         sample, depth, iters, segments) = state
        fpack = jnp.stack(comps + rad + thr, axis=0)          # [13, R]
        ipack = jnp.stack(
            [lane_pixel, sample, depth, alive.astype(jnp.int32)], axis=0)
        perm = jnp.argsort(sort_key(comps, alive), stable=True)
        fpack = jnp.take(fpack, perm, axis=1)
        ipack = jnp.take(ipack, perm, axis=1)
        comps = tuple(fpack[k] for k in range(7))
        rad = tuple(fpack[7 + k] for k in range(3))
        thr = tuple(fpack[10 + k] for k in range(3))
        lane_pixel = ipack[0]
        sample = ipack[1]
        depth = ipack[2]
        alive = ipack[3].astype(bool)
        return (acc_r, acc_g, acc_b, next_w, comps, rad, thr, alive,
                lane_pixel, sample, depth, iters, segments)

    def step(state):
        (acc_r, acc_g, acc_b, next_w, comps, rad, thr, alive, lane_pixel,
         sample, depth, iters, segments) = state

        # --- queue regeneration: dead lanes pull fresh work ---
        dead = ~alive
        rank = jnp.cumsum(dead.astype(jnp.int32)) - dead.astype(jnp.int32)
        wi = next_w + rank
        can = dead & (wi < total_work)
        can_f = jnp.where(can, 1.0, 0.0)
        w_safe = jnp.minimum(wi, total_work - 1)
        new_pixel = tile_l2p[(w_safe % n_pix).astype(jnp.int32)]
        new_sample = (w_safe // n_pix).astype(jnp.int32) + sample_offset
        lane_pixel = jnp.where(can, new_pixel, lane_pixel)
        sample = jnp.where(can, new_sample, sample)
        depth = jnp.where(can, 0, depth)
        alive = alive | can
        next_w = next_w + jnp.sum(can.astype(jnp.int32))

        keys = rng.ray_keys_fast(base_key, pixel_offset + lane_pixel,
                                 sample)
        dkeys = rng.mix_depth(keys, depth)
        uniforms = rng.uniform_block(dkeys, n_u + 6)
        new_comps = generate_ray_components(
            s, frame, pixel_offset + lane_pixel, uniforms[:, n_u:n_u + 5])
        comps = tuple(jnp.where(can, nc, c)
                      for nc, c in zip(new_comps, comps))
        rad = tuple(r * (1.0 - can_f) for r in rad)
        thr = tuple(jnp.where(can, 1.0, t) for t in thr)

        comps, rad, thr, alive, died = _bounce_soa(
            scene, s, comps, uniforms, rad, thr, alive)
        depth = depth + 1
        capped = alive & (depth >= s.max_depth)
        died = died | capped
        alive = alive & ~capped
        if s.rr_depth is not None:
            thr, alive, died = _russian_roulette(
                s, uniforms[:, n_u + 5], depth, thr, alive, died)

        # --- flush: pixel-indexed scatter-add at death ---
        died_f = jnp.where(died, 1.0, 0.0)
        acc_r = acc_r.at[lane_pixel].add(rad[0] * died_f, mode="drop")
        acc_g = acc_g.at[lane_pixel].add(rad[1] * died_f, mode="drop")
        acc_b = acc_b.at[lane_pixel].add(rad[2] * died_f, mode="drop")

        segments = segments + jnp.sum((alive | died).astype(jnp.int32))
        return (acc_r, acc_g, acc_b, next_w, comps, rad, thr, alive,
                lane_pixel, sample, depth, iters + 1, segments)

    def body(state):
        return step(rebin(state))

    def cond(state):
        return jnp.any(state[7]) | (state[3] < total_work)

    z1 = jnp.zeros((lanes,), DTYPE)
    o1 = jnp.ones((lanes,), DTYPE)
    zp = jnp.zeros((n_pix,), DTYPE)
    state = (
        zp, zp, zp, jnp.zeros((), jnp.int32),
        (z1, z1, z1, z1, z1, o1, z1),
        (z1, z1, z1), (o1, o1, o1),
        jnp.zeros((lanes,), bool),
        jnp.zeros((lanes,), jnp.int32),
        jnp.zeros((lanes,), jnp.int32),
        jnp.zeros((lanes,), jnp.int32),
        jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
    )
    state = jax.lax.while_loop(cond, body, state)
    acc_out = acc + jnp.stack(state[0:3], axis=-1)
    if with_stats:
        return acc_out, dict(iterations=state[-2], segments=state[-1],
                             lanes=lanes)
    return acc_out


def _antithetic_maps(cost, k: int):
    """k lane->slot permutations with ~equal per-lane total cost.

    Rank slots by ``cost`` ascending; lane ``l`` serves ranks
    ``l, N-1-l, l+S, N-1-l-S, ...`` (S = N//k shifts keep the k maps
    distinct) — every antithetic rank pair sums to ~2x the mean, so the
    slowest lane's total collapses toward k*mean instead of k*worst.
    Each map is a permutation (every slot served exactly once per
    chunk), so the estimator is exactly the unbalanced one re-ordered.
    Requires even ``k``.  Balancing only helps scenes whose per-pixel
    MEAN cost varies strongly (fog vs sky regions): no static assignment
    shrinks per-SAMPLE path-length variance.
    """
    lanes = cost.shape[0]
    srt = jnp.argsort(cost)
    l = jnp.arange(lanes, dtype=jnp.int32)
    maps = []
    for cc in range(k):
        shift = (cc // 2) * (lanes // k)
        if cc % 2 == 0:
            r = (l + shift) % lanes
        else:
            r = (lanes - 1 - l - shift) % lanes
        maps.append(srt[r])
    return maps


def lane_cost_estimate(scene: Scene, s: CameraSettings, base_key,
                       pixel_ids, spp_est: int = 4,
                       sample_offset: int = 1 << 20):
    """Cheap forward per-lane cost signal for antithetic load balancing:
    total bounce iterations consumed by ``spp_est`` samples of each
    lane's pixel (~spp_est x mean path length).  Runs the forward-only
    regenerating wavefront (a while_loop — no AD) on a sample range
    disjoint from any render, so the balanced render shares no
    randomness with its own cost estimate."""
    lanes = pixel_ids.shape[0]
    n_u = n_bounce_uniforms(scene)
    frame = camera_frame(s)
    last = sample_offset + spp_est - 1

    def body(st):
        cnt, comps, rad, thr, alive, sample, depth = st
        can = ~alive & (sample < last)
        sample = jnp.where(can, sample + 1, sample)
        depth = jnp.where(can, 0, depth)
        alive = alive | can
        keys = rng.ray_keys_fast(base_key, pixel_ids, sample)
        dkeys = rng.mix_depth(keys, depth)
        uniforms = rng.uniform_block(dkeys, n_u + 6)
        nc = generate_ray_components(s, frame, pixel_ids,
                                     uniforms[:, n_u:n_u + 5])
        comps = tuple(jnp.where(can, n, c) for n, c in zip(nc, comps))
        rad = tuple(jnp.where(can, 0.0, x) for x in rad)
        thr = tuple(jnp.where(can, 1.0, x) for x in thr)
        comps, rad, thr, alive, died = _bounce_soa(
            scene, s, comps, uniforms, rad, thr, alive)
        depth = depth + 1
        capped = alive & (depth >= s.max_depth)
        died = died | capped
        alive = alive & ~capped
        if s.rr_depth is not None:
            thr, alive, died = _russian_roulette(
                s, uniforms[:, n_u + 5], depth, thr, alive, died)
        cnt = cnt + (alive | died).astype(jnp.int32)
        return cnt, comps, rad, thr, alive, sample, depth

    def cond(st):
        return jnp.any(st[4] | (st[5] < last))

    z1 = jnp.zeros((lanes,), DTYPE)
    o1 = jnp.ones((lanes,), DTYPE)
    st = (jnp.zeros((lanes,), jnp.int32),
          (z1, z1, z1, z1, z1, o1, z1), (z1, z1, z1), (o1, o1, o1),
          jnp.zeros((lanes,), bool),
          jnp.full((lanes,), sample_offset - 1, jnp.int32),
          jnp.zeros((lanes,), jnp.int32))
    st = jax.lax.while_loop(cond, body, st)
    return st[0].astype(DTYPE)


def trace_wavefront_diff(scene: Scene, s: CameraSettings, base_key,
                         pixel_ids, spp: int, n_iters: int | None = None,
                         sample_offset: int = 0, remat: bool = True,
                         rotate_k: int = 1,
                         skip_done: bool = False,
                         skip_chunk: int = 16,
                         pixel_cost=None,
                         schedule: tuple | None = None):
    """Differentiable pixel-stationary wavefront.

    Reverse-mode AD cannot cross ``while_loop``, and a fixed
    scan-over-max-depth wastes ~90% of its iterations on dead lanes (mean
    Cornell path length ~3 vs depth 50).  This driver runs the same
    regenerating pixel-stationary scheduler as
    :func:`trace_wavefront_stationary` under a *bounded* ``lax.scan``
    (each iteration rematerialized with ``jax.checkpoint`` when
    ``remat``).  The surface hit is the custom-VJP wrapper (winner-only
    analytic backward, ops/diff_intersect.py); the material math is
    differentiated by plain autodiff.

    Returns ``(mean_radiance[P, 3], samples_done[P])``: lanes that run
    out of iterations drop their remaining samples, so the mean is over
    ``samples_done`` (choose ``n_iters`` with slack — default
    ``6 * spp + max_depth`` — and monitor ``samples_done == spp``).

    ``skip_done=True`` wraps each run of ``skip_chunk`` scan iterations
    in a ``lax.cond`` that bypasses the whole bounce once every lane has
    finished its ``spp`` samples.  Off by default: guaranteed completion
    comes from a generous ``n_iters``.

    ``rotate_k`` (must divide ``spp``): as in
    :func:`trace_wavefront_stationary`, rotate each lane through k
    pixels at a large stride so per-lane total work averages per-pixel
    path-length imbalance — the bounded scan then needs fewer
    iterations for the same completion fraction.  Rolls are linear, so
    gradients flow through unchanged.

    ``schedule``: optional tuple of ``(extra_iters, width)`` pairs — the
    *two-phase completion schedule*.  After the ``n_iters`` full-width
    iterations, the unfinished lanes (still mid-path or with samples
    left to start) are **compacted** into ``width`` lanes (stable
    argsort of the unfinished mask + gather of the whole lane state) and
    the scan continues there for ``extra_iters`` more iterations; each
    phase's radiance lands in phase-local accumulators that are
    scattered back to the original lane slots once per phase.  The
    completion tail is per-SAMPLE path-length variance — the max over
    all lanes of a ``spp``-path sum — so most lanes finish long before
    the last one, and running the tail at a fraction of the width drops
    no sample (the compacted lanes carry their absolute (pixel, sample)
    RNG coordinates, so the estimator is EXACTLY the single-phase one;
    only fp add order differs at the final scatter).  Requires
    ``rotate_k == 1`` and ``not skip_done``.
    Monitor ``samples_done``: a phase whose unfinished count exceeds its
    ``width`` drops the overflow lanes' remaining samples.
    """
    lanes = pixel_ids.shape[0]
    if n_iters is None:
        n_iters = 6 * spp + s.max_depth
    # keep ONLY raw uint32 key data inside the scan (wrap at use): the
    # extended key dtype as a cond carry/closure breaks JAX's
    # residual-union typing under the skip-done lax.cond's VJP
    base_raw = jax.random.key_data(base_key)
    k_rot = rotate_k if (rotate_k > 1 and spp % rotate_k == 0) else 1
    spp_k = spp // k_rot
    _BLK = 32 * LANE_ALIGN
    stride = max((lanes // k_rot) // _BLK * _BLK, _BLK)
    if k_rot > 1 and stride % lanes == 0:
        stride = max(lanes // k_rot, 1)
    balanced = (pixel_cost is not None and k_rot > 1 and k_rot % 2 == 0)
    if balanced:
        # Cost-balanced antithetic assignment: the scan must run until
        # the SLOWEST lane finishes, and per-pixel mean path length
        # varies across the image.  Rank pixels by a cheap
        # forward cost estimate (lane_cost_estimate) and give each lane
        # antithetic rank pairs (rank i with rank N-1-i), so every
        # lane's k-pixel total is ~exactly k*mean and the completion
        # bound drops toward the mean.
        lane_maps = _antithetic_maps(jax.lax.stop_gradient(pixel_cost),
                                     k_rot)
        pixel_maps = [pixel_ids[m] for m in lane_maps]
        inv_maps = [jnp.argsort(m) for m in lane_maps]
    else:
        pixel_maps = [jnp.roll(pixel_ids, -cc * stride)
                      for cc in range(k_rot)]
    n_u = n_bounce_uniforms(scene)
    frame = camera_frame(s)
    last_sample = sample_offset + spp - 1

    def make_body(pix_arr):
      def body(state):
        (acc, done, comps, rad, thr, alive, sample, depth, keys) = state

        can = ~alive & (sample < last_sample)
        can_f = jnp.where(can, 1.0, 0.0)
        sample = jnp.where(can, sample + 1, sample)
        if k_rot == 1:
            rot_c = None
            lane_pixel = pix_arr
        else:
            rot_c = jnp.clip(((sample - sample_offset) // spp_k)
                             .astype(jnp.int32), 0, k_rot - 1)
            lane_pixel = pixel_maps[0]
            for cc in range(1, k_rot):
                lane_pixel = jnp.where(rot_c == cc, pixel_maps[cc],
                                       lane_pixel)
        # keys ride the carry as RAW uint32 (extended key dtypes crossing
        # the skip-done lax.cond break JAX's residual-union typing)
        nk = jax.random.key_data(
            rng.ray_keys_fast(jax.random.wrap_key_data(base_raw), lane_pixel, sample))
        keys = jnp.where(can[:, None], nk, keys)
        rad = tuple(x * (1.0 - can_f) for x in rad)
        thr = tuple(jnp.where(can, 1.0, x) for x in thr)
        depth = jnp.where(can, 0, depth)
        alive = alive | can

        dkeys = rng.mix_depth(jax.random.wrap_key_data(keys), depth)
        uniforms = rng.uniform_block(dkeys, n_u + 6)
        new_comps = generate_ray_components(s, frame, lane_pixel,
                                            uniforms[:, n_u:n_u + 5])
        comps = tuple(jnp.where(can, nc, c)
                      for nc, c in zip(new_comps, comps))

        comps, rad, thr, alive, died = _bounce_soa(
            scene, s, comps, uniforms, rad, thr, alive, diff=True)
        depth = depth + 1
        capped = alive & (depth >= s.max_depth)
        died = died | capped
        alive = alive & ~capped
        if s.rr_depth is not None:
            thr, alive, died = _russian_roulette(
                s, uniforms[:, n_u + 5], depth, thr, alive, died,
                detach=True)

        died_f = jnp.where(died, 1.0, 0.0)
        if k_rot == 1:
            acc = tuple(a + r * died_f for a, r in zip(acc, rad))
            done = done + died.astype(jnp.int32)
        else:
            # contribution of lane l belongs to pixel slot
            # (l + c*stride) % lanes: fixed shift per chunk.  Accumulate
            # into per-chunk SEPARATE carries (a tuple, not a [k, R]
            # buffer: .at[cc].add under scan-AD copies the whole buffer
            # per update); the k rolls happen ONCE after the scan.
            acc = list(acc)
            done = list(done)
            for cc in range(k_rot):
                m = (died_f * jnp.where(rot_c == cc, 1.0, 0.0))
                acc[cc] = tuple(a + r * m for a, r in zip(acc[cc], rad))
                done[cc] = done[cc] + m.astype(jnp.int32)
            acc = tuple(acc)
            done = tuple(done)
        return (acc, done, comps, rad, thr, alive, sample, depth,
                keys)
      return body

    body = make_body(pixel_ids)
    z1 = jnp.zeros((lanes,), DTYPE)
    o1 = jnp.ones((lanes,), DTYPE)
    zi = jnp.zeros((lanes,), jnp.int32)
    init_keys = jax.random.key_data(
        rng.ray_keys_fast(base_key, jnp.zeros(lanes, jnp.int32),
                          jnp.zeros(lanes, jnp.int32)))
    if k_rot == 1:
        acc0, done0 = (z1, z1, z1), zi
    else:
        acc0 = tuple((z1, z1, z1) for _ in range(k_rot))
        done0 = tuple(zi for _ in range(k_rot))
    state = (
        acc0, done0,
        (z1, z1, z1, z1, z1, o1, z1),       # o, d (dummy unit z), time
        (z1, z1, z1), (o1, o1, o1),         # radiance, throughput
        jnp.zeros((lanes,), bool),
        jnp.full((lanes,), sample_offset - 1, jnp.int32),
        jnp.zeros((lanes,), jnp.int32), init_keys,
    )
    body_r = jax.checkpoint(body) if remat else body
    if skip_done:
        k_skip = max(1, min(skip_chunk, n_iters))
        n_outer = n_iters // k_skip
        k_rem = n_iters - n_outer * k_skip

        # Skip k_skip iterations at once when every lane is done: the
        # untaken cond branch is genuinely not executed (forward OR
        # backward), and the per-cond state-copy overhead amortizes
        # over the chunk.  A final short chunk of k_rem iterations keeps
        # the total EXACTLY n_iters, so skip_done is a pure semantic
        # no-op vs skip_done=False even when samples don't all complete.
        def make_chunk(k):
            def chunk(st):
                st, _ = jax.lax.scan(lambda s2, _: (body_r(s2), None),
                                     st, None, length=k)
                return st
            return chunk

        def make_stepped(k):
            chunk = make_chunk(k)

            def stepped(st, _):
                go = jnp.any(st[5]) | jnp.any(st[6] < last_sample)
                return jax.lax.cond(go, chunk, lambda s_: s_, st), None
            return stepped

        if n_outer:
            state, _ = jax.lax.scan(make_stepped(k_skip), state, None,
                                    length=n_outer)
        if k_rem:
            state, _ = make_stepped(k_rem)(state, None)
    else:
        state, _ = jax.lax.scan(lambda st, _: (body_r(st), None), state,
                                None, length=n_iters)

    if schedule:
        if k_rot != 1 or skip_done:
            raise ValueError("schedule requires rotate_k=1, skip_done=False")
        acc, done = state[0], state[1]
        carries = state[2:9]                 # comps, rad, thr, alive, sample, depth, keys
        slot = jnp.arange(lanes, dtype=jnp.int32)
        for it_b, w_b in schedule:
            comps_c, rad_c, thr_c, alive_c, sample_c, depth_c, keys_c = carries
            # stable sort: unfinished lanes (key False) first, original
            # order preserved → deterministic compaction
            unfinished = alive_c | (sample_c < last_sample)
            sel = jnp.argsort(~unfinished)[:w_b]
            slot = slot[sel]
            carries = jax.tree_util.tree_map(lambda x: x[sel], carries)
            zb = jnp.zeros((w_b,), DTYPE)
            st_b = ((zb, zb, zb), jnp.zeros((w_b,), jnp.int32)) + carries
            body_b = make_body(pixel_ids[slot])
            body_b = jax.checkpoint(body_b) if remat else body_b
            st_b, _ = jax.lax.scan(lambda st, _: (body_b(st), None), st_b,
                                   None, length=it_b)
            acc = tuple(a.at[slot].add(ab) for a, ab in zip(acc, st_b[0]))
            done = done.at[slot].add(st_b[1])
            carries = st_b[2:9]
        state = (acc, done) + carries

    acc, done = state[0], state[1]
    if k_rot > 1 and balanced:
        # chunk carries -> lane slots: slot s's chunk-cc contribution
        # came from lane inv_maps[cc][s] — one gather per chunk
        acc = tuple(
            sum(acc[cc][ch][inv_maps[cc]] for cc in range(k_rot))
            for ch in range(3))
        done = sum(done[cc][inv_maps[cc]] for cc in range(k_rot))
    elif k_rot > 1:
        # chunk carries -> lane slots: one roll per chunk, post-scan
        acc = tuple(
            sum(jnp.roll(acc[cc][ch], cc * stride) for cc in range(k_rot))
            for ch in range(3))
        done = sum(jnp.roll(done[cc], cc * stride) for cc in range(k_rot))
    mean = jnp.stack(acc, axis=-1) / jnp.maximum(done, 1)[:, None]
    return mean, done
