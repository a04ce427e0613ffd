"""Texture-table gradients against a dense reference.

Reverse-mode gradients of ``eval_texture`` w.r.t. the texture table
flow back through per-lane gathers (a scatter-add, or the transpose of
the one-hot matmul).  The reference builds the same gradient densely:
for image textures, by adding each lane's cotangent at its texel in
float64; for marble, by differentiating each lane's stripe w.r.t. its
OWN parameter copy (forward mode) and summing per texture row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raytrace_tpu as rt
from raytrace_tpu.textures.noise import turbulence
from raytrace_tpu.textures.textures import compile_textures, eval_texture


def _lanes(n, n_tex, seed):
    r = np.random.default_rng(seed)
    ids = r.integers(0, n_tex, n).astype(np.int32)
    pts = r.uniform(-3, 3, (n, 3)).astype(np.float32)
    w = r.normal(size=(n, 3)).astype(np.float32)
    return r, jnp.asarray(ids), jnp.asarray(pts), jnp.asarray(w)


@pytest.mark.parametrize("sizes", [((8, 16),), ((8, 16), (5, 7))],
                         ids=["one-image", "two-images-padded"])
def test_image_texture_gradient_matches_dense(sizes):
    r = np.random.default_rng(len(sizes))
    texs = [rt.image_texture(r.uniform(0, 1, (h, w_, 3)))
            for h, w_ in sizes] + [rt.constant_texture(0.3)]
    table = compile_textures(texs)
    n = 2048
    r, ids, pts, w = _lanes(n, len(texs), 3)
    # uv at texel centres: the texel index is exact in f32 and f64
    hw = np.asarray([sizes[k] if k < len(sizes) else (1, 1)
                     for k in np.asarray(ids)])
    ci = r.integers(0, 1 << 20, n) % hw[:, 1]
    cj = r.integers(0, 1 << 20, n) % hw[:, 0]
    uvs = np.stack([(ci + 0.5) / hw[:, 1], 1.0 - (cj + 0.5) / hw[:, 0]], -1)

    def f(images):
        t = table.replace(images=images)
        return jnp.sum(w * eval_texture(t, ids, pts,
                                        jnp.asarray(uvs, jnp.float32)))

    got = np.asarray(jax.grad(f)(table.images))
    ref = np.zeros(table.images.shape)
    img = np.asarray(ids)
    sel = img < len(sizes)
    np.add.at(ref, (img[sel], cj[sel], ci[sel]),
              np.asarray(w, np.float64)[sel])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("onehot", [False, True], ids=["gather", "onehot"])
def test_marble_gradient_matches_dense(onehot):
    texs = [rt.marble_texture([0.3, 0.0, 0.1], 2.0, [0.1, 0.2, 0.3]),
            rt.marble_texture([0.0, 0.2, 0.05], 4.0),
            rt.constant_texture(0.5),
            rt.marble_texture([0.1, 0.1, 0.1], 1.0, [1.0, 0.0, 0.0])]
    table = compile_textures(texs)
    n = 512
    _, ids, pts, w = _lanes(n, len(texs), 5)

    def f(v0, v1, f0):
        t = table.replace(v0=v0, v1=v1, f0=f0)
        return jnp.sum(w * eval_texture(t, ids, pts, jnp.zeros((n, 2)),
                                        onehot=onehot))

    got = jax.grad(f, argnums=(0, 1, 2))(table.v0, table.v1, table.f0)

    def stripe(v0, v1, f0, p):         # Texture.hs:72-79, one lane
        return 0.5 + 0.5 * jnp.sin(
            f0 * jnp.dot(v0, p) + 10.0 * turbulence(7, 0.25 * f0 * p + v1))

    per_lane = jax.vmap(jax.jacfwd(stripe, argnums=(0, 1, 2)))(
        table.v0[ids], table.v1[ids], table.f0[ids], pts)
    scale = np.asarray(jnp.sum(w, axis=1), np.float64)
    marble = np.asarray(table.kind)[np.asarray(ids)] == 4
    for g, lane in zip(got, per_lane):
        ref = np.zeros(g.shape)
        lane = np.asarray(lane, np.float64)
        contrib = lane * scale.reshape((-1,) + (1,) * (lane.ndim - 1))
        np.add.at(ref, np.asarray(ids)[marble], contrib[marble])
        np.testing.assert_allclose(np.asarray(g), ref, rtol=2e-4, atol=2e-4)
