"""Top-level render driver: the wavefront form of ``raytrace`` (Ray.hs:121).

Replaces the reference's per-pixel spark fan-out (``A.makeArray A.Par``,
Ray.hs:238) with the *persistent wavefront* (render/integrator.py): one
jitted launch processes chunks of the (pixel x sample) work queue with a
fixed lane pool, regenerating dead lanes so occupancy stays ~100%.  Work
items are deterministic in (pixel, sample) coordinates, so the image is
independent of lane count, chunking, and device layout.

Progressive rendering / checkpoint-resume: :func:`render_accumulate`
returns the raw (sum, samples-done) pair that can be checkpointed and
continued (SURVEY.md §5).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng
from ..core.vecmath import DTYPE
from ..scene.types import Scene
from .camera import CameraSettings
from .integrator import (
    SORT_MIN_PRIMS, trace_wavefront, trace_wavefront_sorted,
    trace_wavefront_stationary,
)

# Below this many pixels, the pixel-stationary scheduler can't fill the
# vector lanes; use the work-queue scheduler instead.
_STATIONARY_MIN_PIXELS = 16384
# Media whose boundary has at least this many rows (mesh-boundary media)
# also take the ray-binned driver.  Not measured on the card (ROADMAP A7).
MESH_VOLUME_MIN_ROWS = 64


def render_accumulate(scene: Scene, settings: CameraSettings, seed: int = 0,
                      *, spp: int | None = None, n_lanes: int = 1 << 17,
                      spp_chunk: int | None = None, acc=None, spp_done: int = 0,
                      progress: bool = False, max_band: int = 1 << 19):
    """Accumulate radiance sums for ``spp`` samples/pixel.

    Returns ``(acc, spp_total)`` where ``acc[n_pix, 3]`` is the radiance
    *sum*; ``acc / spp_total`` is the image.  Pass a previous ``(acc,
    spp_done)`` to resume.  ``spp_chunk`` bounds work per device launch;
    images larger than ``max_band`` pixels render in row-aligned bands
    (bounds the wavefront's device-memory working set — lane state is
    ~100 B/pixel).
    """
    h = settings.image_height
    w = settings.image_width
    n_pix = h * w
    spp = spp if spp is not None else settings.samples_per_pixel
    key = rng.base_key(seed)

    if acc is None:
        acc = jnp.zeros((n_pix, 3), DTYPE)

    # Row-aligned pixel bands bound the wavefront's working set
    # (lane state is ~100 B/pixel).  Equal-row bands except possibly the
    # last, so at most two program shapes compile.
    if n_pix > max_band >= w:
        n_bands = -(-n_pix // max_band)
        band_rows = -(-h // n_bands)
    else:
        band_rows = h
    bands = []
    r0 = 0
    while r0 < h:
        rows = min(band_rows, h - r0)
        bands.append((r0 * w, rows * w))
        r0 += rows

    stationary = bands[0][1] >= _STATIONARY_MIN_PIXELS
    if spp_chunk is None:
        if stationary:
            # The drain tail (lanes whose pixels drew long paths finish
            # last) is paid once per launch and amortizes over samples,
            # so launch everything at once unless the caller asked for
            # progress/checkpoint granularity.
            spp_chunk = min(spp, 512)
        else:
            # Each launch ends with a low-occupancy drain tail (long
            # survivor paths); queue >= ~32 lane-fills amortizes it.
            spp_chunk = max(1, min(spp, -(-32 * n_lanes // max(n_pix, 1))))

    done = 0
    while done < spp:
        n_s = min(spp_chunk, spp - done)
        # samples [spp_done+done, ...+n_s) — absolute sample coordinates
        s0 = jnp.asarray(spp_done + done, jnp.int32)
        if stationary:
            # Pixel rotation averages per-PIXEL mean path-length imbalance
            # (sky lanes finish their samples long before fog/glass
            # lanes).  Largest divisor of
            # the chunk <= 8: more chunks average better but each costs a
            # masked roll per iteration.  Per-sample path-length noise
            # (Cornell-style tails) is handled by rr_depth, not rotation.
            rot = 1
            for k in range(8, 1, -1):
                if n_s % k == 0:
                    rot = k
                    break
            for off, bp in bands:
                band = _stationary_jit(scene, settings, key, None, s0,
                                       n_pix=bp, spp=n_s, rotate_k=rot,
                                       pixel_offset=off)
                acc = jax.lax.dynamic_update_slice_in_dim(
                    acc, jax.lax.dynamic_slice_in_dim(acc, off, bp) + band,
                    off, axis=0)
        else:
            acc = _queue_jit(scene, settings, key, acc, s0, n_pix=n_pix,
                             spp=n_s, n_lanes=min(n_lanes, n_pix * n_s))
        done += n_s
        if progress:
            print(f"\r  spp {done}/{spp}", end="", flush=True)
    if progress:
        print()
    return acc, spp_done + spp


def _queue_fn(scene, settings, key, acc, s0, n_pix, spp, n_lanes):
    return trace_wavefront(scene, settings, key, n_pix, spp, n_lanes, acc,
                           sample_offset=s0)


def _stationary_fn(scene, settings, key, acc, s0, n_pix, spp, rotate_k=1,
                   pixel_offset=0):
    """Mesh-scale scenes (and mesh-boundary media) take the ray-binned
    work-queue driver, the rest the pixel-stationary one.  Both give the
    same image (absolute (pixel, sample) RNG keys); ``rotate_k`` applies
    only to the stationary driver."""
    mesh_volumes = (scene.volumes is not None
                    and scene.volumes.prims.kind.shape[0]
                    >= MESH_VOLUME_MIN_ROWS)
    if ((scene.prims.kind.shape[0] >= SORT_MIN_PRIMS or mesh_volumes)
            and scene.bvh is None):
        return trace_wavefront_sorted(scene, settings, key, n_pix, spp,
                                      acc, sample_offset=s0,
                                      pixel_offset=pixel_offset)
    return trace_wavefront_stationary(scene, settings, key, n_pix, spp, acc,
                                      sample_offset=s0, rotate_k=rotate_k,
                                      pixel_offset=pixel_offset)


_queue_jit = jax.jit(_queue_fn, static_argnames=("n_pix", "spp", "n_lanes"))
_stationary_jit = jax.jit(_stationary_fn,
                          static_argnames=("n_pix", "spp", "rotate_k",
                                           "pixel_offset"))


def render(scene: Scene, settings: CameraSettings, seed: int = 0,
           *, spp: int | None = None, n_lanes: int = 1 << 17,
           spp_chunk: int | None = None, progress: bool = False):
    """Render an image [H, W, 3] of linear RGB."""
    spp = spp if spp is not None else settings.samples_per_pixel
    acc, total = render_accumulate(
        scene, settings, seed, spp=spp, n_lanes=n_lanes,
        spp_chunk=spp_chunk, progress=progress)
    h = settings.image_height
    w = settings.image_width
    return np.asarray(acc / total).reshape(h, w, 3)
