"""Differentiable rendering utilities.

The reference computes no gradients; the BASELINE north-star requires
pixel -> (material albedo, texture, geometry params) gradients via
reparameterized/detached sampling.  The integrator already detaches
sampled directions and MIS pdf denominators (render/integrator.py); this
module provides the parameter plumbing:

* :func:`partition` / :func:`combine` — split a Scene (or any pytree) into
  its float leaves (differentiable parameters: primitive geometry, texture
  colors, material scalars, camera vectors) and everything else
  (topology/int tables), so ``jax.grad`` differentiates exactly the
  physical parameters.
* :func:`render_loss` / :func:`grad_render` — loss + gradient of a
  rendered tile against a target, the inverse-rendering building block.
* :func:`finite_difference` — central-difference harness used by the
  gradient tests (SURVEY.md §4 implication (b)).
"""
from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp

from ..core import rng
from ..render.camera import CameraSettings, camera_frame, generate_rays
from ..render.integrator import trace
from ..scene.types import Scene


def _is_float_leaf(x) -> bool:
    return hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)


def partition(tree):
    """Split pytree into (params, statics): params keeps float leaves
    (others None), statics the rest."""
    params = jax.tree_util.tree_map(
        lambda x: x if _is_float_leaf(x) else None, tree)
    statics = jax.tree_util.tree_map(
        lambda x: None if _is_float_leaf(x) else x, tree)
    return params, statics


def combine(params, statics):
    """Inverse of :func:`partition`."""
    return jax.tree_util.tree_map(
        lambda p, s: p if s is None else s, params, statics,
        is_leaf=lambda x: x is None)


def render_tile(scene: Scene, settings: CameraSettings, key, pixel_ids,
                sample_ids, differentiable: bool = False):
    """Radiance [P, 3] for pixels ``pixel_ids[P]``, averaged over the
    samples ``sample_ids[S]`` (vmapped: the spp axis is a real array axis,
    shardable across devices)."""

    def one_sample(sid):
        keys = rng.ray_keys_fast(key, pixel_ids, jnp.full_like(pixel_ids, sid))
        frame = camera_frame(settings)
        o, d, time = generate_rays(settings, frame, pixel_ids, keys)
        return trace(scene, settings, o, d, time, rng.site(keys, 7),
                     differentiable=differentiable)

    out = jax.vmap(one_sample)(sample_ids)          # [S, P, 3]
    return jnp.mean(out, axis=0)


def render_loss(scene_params, scene_statics, settings, key, pixel_ids,
                sample_ids, target):
    """MSE of a rendered tile vs ``target[P, 3]`` — differentiable w.r.t.
    ``scene_params`` (all float leaves of the scene)."""
    scene = combine(scene_params, scene_statics)
    img = render_tile(scene, settings, key, pixel_ids, sample_ids,
                      differentiable=True)
    return jnp.mean((img - target) ** 2)


def render_loss_wavefront(scene_params, scene_statics, settings, key,
                          pixel_ids, target, spp: int,
                          n_iters: int | None = None, remat: bool = True,
                          rotate_k: int = 1, skip_done: bool = False,
                          skip_chunk: int = 16, pixel_cost=None,
                          schedule: tuple | None = None):
    """MSE loss via the differentiable *regenerative* wavefront
    (render/integrator.py:trace_wavefront_diff) — ~10x less wasted work
    than the bounded-depth scan for deep max_depth settings.

    ``remat=False`` stores per-iteration residuals of the whole bounce
    instead of rematerializing each bounce in the backward: faster when
    they fit in device memory (compiled ``memory_analysis()`` says)."""
    from ..render.integrator import trace_wavefront_diff

    scene = combine(scene_params, scene_statics)
    img, done = trace_wavefront_diff(scene, settings, key, pixel_ids, spp,
                                     n_iters=n_iters, remat=remat,
                                     rotate_k=rotate_k, skip_done=skip_done,
                                     skip_chunk=skip_chunk,
                                     pixel_cost=pixel_cost,
                                     schedule=schedule)
    loss = jnp.mean((img - target) ** 2)
    # aux: fraction of requested samples completed within the iteration
    # budget (should be ~1.0; raise n_iters if it drops)
    return loss, jnp.mean(done / spp)


def grad_render(scene: Scene, settings, key, pixel_ids, sample_ids, target):
    """(loss, gradient-scene) — gradient leaves are zero for non-float."""
    params, statics = partition(scene)
    loss, grads = jax.value_and_grad(render_loss)(
        params, statics, settings, key, pixel_ids, sample_ids, target)
    return loss, grads


def finite_difference(f: Callable[[jnp.ndarray], Any], x, eps: float = 1e-3):
    """Central finite differences of scalar ``f`` at 1-D ``x``."""
    x = jnp.asarray(x)
    grads = []
    for i in range(x.size):
        dx = jnp.zeros_like(x).at[i].set(eps)
        grads.append((f(x + dx) - f(x - dx)) / (2 * eps))
    return jnp.stack(grads)
