"""Multi-host rendering: ``jax.distributed`` + the sharded wavefront.

The reference is a single shared-memory process (SURVEY.md §2.2 — its only
parallelism is massiv's per-pixel spark scheduler, Ray.hs:238).  Here the
same embarrassingly-parallel pixel dimension scales across *hosts*: every
process joins a ``jax.distributed`` job, builds one global mesh over all
devices, and runs the shard_map persistent wavefront
(parallel/sharding.py) on its addressable shard of the pixel axis.  The
scene is tiny (<= a few thousand primitives in every reference scene) and
is replicated; the only cross-host traffic is the final image assembly.

Determinism: RNG is keyed on absolute (pixel, sample) ids (core/rng.py),
so the rendered image is bit-identical for any host/chip count — the
multi-host generalization of the reference's pre-split seed matrix
(Ray.hs:234-236).

Usage (one process per host, e.g. under SLURM/GKE):

    from raytrace_tpu.parallel import multihost
    multihost.initialize()                # reads env / cluster autodetect
    img = multihost.render(scene, settings, seed=0)   # full image on all hosts
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..core import rng
from ..render.camera import CameraSettings
from ..scene.types import Scene
from .sharding import sharded_wavefront_render_fn


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join (or start) a multi-host JAX job.

    With no arguments, relies on cluster auto-detection (e.g. SLURM).  No-op when the job is single-process and no coordinator is
    given.
    """
    if (coordinator_address is None and num_processes is None
            and jax.process_count() == 1 and process_id is None):
        try:
            jax.distributed.initialize()
        except Exception:
            return  # single process, no cluster env: stay local
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh() -> Mesh:
    """1-D ("dp", "sp"=1) mesh over every device of every host, ordered
    so the dp axis is contiguous per host (pixel blocks cross the network
    only between hosts)."""
    devs = np.asarray(jax.devices()).reshape(len(jax.devices()), 1)
    return Mesh(devs, ("dp", "sp"))


def render(scene: Scene, settings: CameraSettings, seed: int = 0,
           spp: int | None = None, mesh: Mesh | None = None) -> np.ndarray:
    """Render the full image, sharded over all hosts' chips.

    Every process returns the complete [H, W, 3] image (assembled with an
    all-gather of the pixel shards — the only cross-host communication).
    """
    mesh = mesh or global_mesh()
    spp = spp if spp is not None else settings.samples_per_pixel
    h, w = settings.image_height, settings.image_width
    n_pix = h * w
    fn = sharded_wavefront_render_fn(mesh, n_pix, spp)
    acc = fn(scene, settings, rng.base_key(seed))
    # Assemble: the output is dp-sharded; gather the global array. For
    # multi-host, addressable shards differ per process — use
    # multihost_utils to materialize the full image everywhere.
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        acc = multihost_utils.process_allgather(acc, tiled=True)
    img = np.asarray(acc)[:n_pix] / spp
    return img.reshape(h, w, 3)
