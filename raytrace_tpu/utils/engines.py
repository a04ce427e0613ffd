"""Engine-selection observability.

Every driver/engine choice in the framework is a *static* predicate of
(scene, settings, lane count) — the same conditions the drivers
evaluate at trace time (render/render.py:_stationary_fn,
ops/intersect.py:nearest_hit_t, render/integrator.py:_surface_hit).
:func:`engine_report` makes the selection inspectable so tests and
benchmarks can ASSERT which engine serves a scene class instead of
discovering a fallback in a wall-clock regression.

The report mirrors the drivers' decisions; it does not influence them.
`tests/test_engines.py` pins the expected engine per scene class.
"""
from __future__ import annotations


def engine_report(scene, s, *, n_pix: int | None = None,
                  diff: bool = False) -> dict:
    """Which engine serves each stage of a render of ``scene``.

    Returns a dict with keys:

    * ``driver`` — ``queue`` | ``sorted`` | ``stationary`` (forward) or
      ``diff-wavefront`` (``diff=True``)
    * ``intersect`` — ``dense-scan`` (all rows, in [R, C] tiles) |
      ``bvh`` (per-lane threaded-BVH loop)
    * ``backward`` (diff only, else None) — ``winner-replay``: the
      custom-VJP surface hit re-derives the winner's hit, the material
      math is plain autodiff
    * ``volumes`` — ``crossing-scan`` | None (no media)

    ``n_pix`` defaults to the settings' full image.
    """
    from ..render import render

    if n_pix is None:
        n_pix = int(s.image_width) * int(s.image_height)

    # ---- driver (render/render.py) ----
    if diff:
        driver = "diff-wavefront"
    elif n_pix < render._STATIONARY_MIN_PIXELS:
        driver = "queue"
    else:
        mesh_volumes = (scene.volumes is not None
                        and scene.volumes.prims.kind.shape[0]
                        >= render.MESH_VOLUME_MIN_ROWS)
        if ((scene.prims.kind.shape[0] >= render.SORT_MIN_PRIMS
             or mesh_volumes)
                and scene.bvh is None):
            driver = "sorted"
        else:
            driver = "stationary"

    # ---- intersect (the diff path's custom-VJP hit always scans) ----
    intersect = "bvh" if (scene.bvh is not None and not diff) \
        else "dense-scan"

    return {"driver": driver, "intersect": intersect,
            "backward": "winner-replay" if diff else None,
            "volumes": "crossing-scan" if scene.volumes is not None
            else None}
