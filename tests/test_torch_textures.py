"""Inverse trig, hit records and texture sampling of the port against the JAX
package's, on the same numpy inputs.

The cephes polynomials (`vatan`, `vatan2`, `vasin`) fix which texel an image
lookup reads, so they are held bit-equal to eager JAX. The records and the
texture samples are held to 1e-6 of their scale (sin and the Perlin gathers
may round differently in the last place between XLA and torch); indices and
material ids exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniraytracer_tpu.models import textures as jtex
from miniraytracer_tpu.ops import intersect as jix
from miniraytracer_tpu.ops import vecmath as jvm
from miniraytracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from miniraytracer_tpu_torch.models import textures as ttex
from miniraytracer_tpu_torch.ops import intersect as tix
from miniraytracer_tpu_torch.ops import vecmath as tvm
from miniraytracer_tpu_torch.scene.builder import SceneBuilder

torch.set_num_threads(1)


def _j3(a):
    return jvm.V3(*(jnp.asarray(a[:, k]) for k in range(3)))


def _t3(a):
    return tvm.V3(*(torch.as_tensor(np.ascontiguousarray(a[:, k])) for k in range(3)))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _same_bits(a, b):
    """Equal float32 bit patterns, but for the sign of a zero."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return (_bits(a) == _bits(b)) | ((a == 0) & (b == 0))


def test_inverse_trig_bit_equal_jax():
    rs = np.random.default_rng(0)
    n = 150_000
    special = np.array([0.0, -0.0, 1.0, -1.0, 2.414213562373095, 0.4142135623730951,
                        -2.4142137, 0.41421357, 1e-30, -1e-30, 1e30, -1e30, 0.5, -0.5],
                       np.float32)
    x = np.concatenate([rs.normal(size=n).astype(np.float32) * 3, special,
                        np.zeros(6, np.float32)])
    y = np.concatenate([rs.normal(size=n).astype(np.float32), special[::-1],
                        np.array([0, 1, -1, 0.0, -0.0, 2], np.float32)])
    assert _same_bits(jvm.vatan(jnp.asarray(x)), tvm.vatan(torch.as_tensor(x)).numpy()).all()
    # all four quadrants, both axes and (0, 0)
    a = np.asarray(jvm.vatan2(jnp.asarray(y), jnp.asarray(x)))
    b = tvm.vatan2(torch.as_tensor(y), torch.as_tensor(x)).numpy()
    assert _same_bits(a, b).all()
    assert b[-6] == 0.0 and b[-5] == np.float32(np.pi / 2) and b[-4] == -np.float32(np.pi / 2)
    np.testing.assert_allclose(b[:n], np.arctan2(y[:n].astype(np.float64), x[:n]), atol=3e-7)
    yc = np.clip(np.concatenate([y, np.array([1, -1, 0.99999994, -0.99999994], np.float32)]),
                 -1, 1)
    a = np.asarray(jvm.vasin(jnp.asarray(yc)))
    b = tvm.vasin(torch.as_tensor(yc)).numpy()
    assert _same_bits(a, b).all()
    assert b[-4] == np.float32(np.pi / 2) and b[-3] == -np.float32(np.pi / 2)


def _textured_scene(builder_cls):
    """Every texture kind on spheres and triangles, two images of different
    sizes (so the atlas pads one)."""
    rs = np.random.RandomState(4)
    b = builder_cls()
    b.set_camera([0, 3, 12], [0, 1, 0], [0, 1, 0], 40.0, 1.0, aperture=0.0,
                 focus_dist=10.0, t0=0.0, t1=1.0)
    mats = [
        b.lambertian(b.tex_const([0.7, 0.3, 0.2])),
        b.lambertian(b.tex_checker([0.2, 0.3, 0.1], [0.9, 0.9, 0.9], 3.0)),
        b.lambertian(b.tex_perlin(2.0)),
        b.lambertian(b.tex_image(rs.uniform(0, 1, (16, 40, 3)).astype(np.float32))),
        b.metal(b.tex_image((rs.uniform(0, 1, (33, 20, 3)) * 255).astype(np.uint8)), 0.4),
        b.dielectric(1.5),
    ]
    for i in range(40):
        p = rs.uniform(-4, 4, 3)
        r = rs.uniform(0.2, 0.8) * (-1 if i == 7 else 1)
        if i % 4 == 0:
            b.sphere(p.tolist(), r, mats[i % 6], center1=(p + [0.0, 0.4, 0.1]).tolist(),
                     t0=0.0, t1=1.0)
        else:
            b.sphere(p.tolist(), r, mats[i % 6])
    for i in range(30):
        p = rs.uniform(-4, 4, 3)
        b.triangle(p.tolist(), (p + rs.uniform(-1, 1, 3)).tolist(),
                   (p + rs.uniform(-1, 1, 3)).tolist(), mats[i % 6])
    return b.build()


def _record_inputs(n, n_prims, seed):
    rs = np.random.default_rng(seed)
    ro = rs.uniform(-6, 6, (n, 3)).astype(np.float32)
    rd = rs.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    time = rs.random(n, dtype=np.float32)
    inside = rs.integers(0, 2, n).astype(np.int32)
    t = rs.uniform(0.1, 9, n).astype(np.float32)
    idx = rs.integers(0, n_prims, n).astype(np.int32)
    return ro, rd, time, inside, t, idx


def _close(a, b, scale=None):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(a).max()), 1.0) if scale is None else scale
    assert np.abs(a - b).max() <= 1e-6 * scale, np.abs(a - b).max()


def test_image_atlas_equals_jax():
    js, ts = _textured_scene(JSceneBuilder), _textured_scene(SceneBuilder)
    assert ts.has_image and ts.images.shape == (2, 33, 40)
    assert ts.images.dtype == torch.uint32
    np.testing.assert_array_equal(np.asarray(js.images), ts.images.numpy())
    np.testing.assert_array_equal(np.asarray(js.tex_c1), ts.tex_c1.numpy())
    np.testing.assert_array_equal(np.asarray(js.tex_img), ts.tex_img.numpy())


@pytest.mark.parametrize("kind", ["sphere", "tri"])
def test_hit_records_match_jax(kind):
    js, ts = _textured_scene(JSceneBuilder), _textured_scene(SceneBuilder)
    n_prims = 40 if kind == "sphere" else 30
    ro, rd, time, inside, t, idx = _record_inputs(4000, n_prims, 1)
    jr = jix.Rays(_j3(ro), _j3(rd), jnp.asarray(time), jnp.asarray(inside))
    tr = tix.Rays(_t3(ro), _t3(rd), torch.as_tensor(time), torch.as_tensor(inside))
    jrec = (jix.sphere_record if kind == "sphere" else jix.tri_record)(
        js, jr, jnp.asarray(t), jnp.asarray(idx))
    trec = (tix.sphere_record if kind == "sphere" else tix.tri_record)(
        ts, tr, torch.as_tensor(t), torch.as_tensor(idx))
    for a, b in zip(jrec[0], trec[0]):  # p
        _close(a, b.numpy())
    for a, b in zip(jrec[1], trec[1]):  # n
        _close(a, b.numpy(), 1.0)
    np.testing.assert_array_equal(np.asarray(jrec[4]), trec[4].numpy())
    if kind == "sphere":
        # uv through the same polynomials: equal unless the normal itself
        # differs in its last place
        for a, b in zip(jrec[2:4], trec[2:4]):
            _close(a, b.numpy(), 1.0)
    else:
        # barycentrics of arbitrary (t, idx) pairs divide by det: relative
        a, b = np.asarray(jrec[2]), trec[2].numpy()
        assert (np.abs(a - b) <= 1e-5 * (1 + np.abs(a))).mean() > 0.999


def test_sphere_uv_texels_equal_jax_at_poles_and_seam():
    """Normals on the axes, at the poles and on the u seam: the same texel."""
    js, ts = _textured_scene(JSceneBuilder), _textured_scene(SceneBuilder)
    dirs = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
                     [-1, 0, 1e-7], [-1, 0, -1e-7], [1e-4, 1, 0], [0.6, 0.8, 0]], np.float32)
    n = len(dirs)
    ro = np.zeros((n, 3), np.float32)
    # sphere 1 (static, radius r) centred at c: hit point c + r*dir
    c, r = ts.sph_c0[1].numpy(), float(ts.sph_radius[1])
    ro[:] = c
    t = np.full(n, abs(r), np.float32)
    idx = np.ones(n, np.int32)
    zeros, izeros = np.zeros(n, np.float32), np.zeros(n, np.int32)
    jrec = jix.sphere_record(js, jix.Rays(_j3(ro), _j3(dirs), jnp.asarray(zeros),
                                          jnp.asarray(izeros)), jnp.asarray(t), jnp.asarray(idx))
    trec = tix.sphere_record(ts, tix.Rays(_t3(ro), _t3(dirs), torch.as_tensor(zeros),
                                          torch.as_tensor(izeros)),
                             torch.as_tensor(t), torch.as_tensor(idx))
    for a, b in zip(jrec[2:4], trec[2:4]):
        assert _same_bits(a, b.numpy()).all()
    for img in (0, 1):
        iid = np.full(n, img, np.int32)
        h, w = ts.tex_c1[3 + img, 0], ts.tex_c1[3 + img, 1]
        a = jtex.image_sample(js, jnp.asarray(iid), jnp.full(n, float(h)), jnp.full(n, float(w)),
                              jrec[2], jrec[3])
        b = ttex.image_sample(ts, torch.as_tensor(iid), torch.full((n,), float(h)),
                              torch.full((n,), float(w)), trec[2], trec[3])
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_sample_texture_matches_jax():
    js, ts = _textured_scene(JSceneBuilder), _textured_scene(SceneBuilder)
    rs = np.random.default_rng(2)
    n = 6000
    tex_id = rs.integers(0, ts.tex_type.shape[0], n).astype(np.int32)
    u = rs.random(n, dtype=np.float32)
    v = rs.random(n, dtype=np.float32)
    u[:4], v[:4] = [0, 1, 0, 1], [0, 0, 1, 1]
    p = rs.uniform(-5, 5, (n, 3)).astype(np.float32)
    a = jtex.sample_texture(js, jnp.asarray(tex_id), jnp.asarray(u), jnp.asarray(v), _j3(p))
    b = ttex.sample_texture(ts, torch.as_tensor(tex_id), torch.as_tensor(u),
                            torch.as_tensor(v), _t3(p))
    kinds = ts.tex_type.numpy()[tex_id]
    assert set(kinds.tolist()) == {0, 1, 2, 3}
    for x, y in zip(a, b):
        x, y = np.asarray(x), y.numpy()
        # image and constant lanes exactly; a checker lane flips only where
        # the sine product is within rounding of zero; Perlin to 1e-6
        exact = (kinds == 0) | (kinds == 3)
        np.testing.assert_array_equal(x[exact], y[exact])
        assert (x[kinds == 1] == y[kinds == 1]).mean() > 0.999
        assert np.abs(x[kinds == 2] - y[kinds == 2]).max() <= 2e-6
