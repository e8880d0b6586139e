"""The port's host utilities against the JAX package's, on seeded inputs:

- the (..., 3) vecmath helpers (`ops/vecmath.py`): within 1e-6 absolute of
  JAX's (the same float32 operations in the same order), `argb32` equal to
  JAX's uint32 bit for bit;
- `ops/mat4.py` on the seven cases of tests/test_mat4.py, within 1e-6 of JAX's;
- `utils/tonemap.py` (drago, reinhard, gamma) on a seeded HDR frame, within
  1e-5 relative (log10, log, pow and exp round differently in torch and XLA);
- `utils/image.py`: `save_png` read back by `read_png`, and, where PIL is
  importable, decoded by PIL equal to JAX's `save_png` of the same frame;
  `save_ppm` bytes equal to JAX's;
- `utils/checkpoint.py`: checkpoints written by either package load in the
  other, a bare path without '.npz' included;
- `utils/terminal.py`: `ansi_frame` and `LiveView` equal to JAX's strings;
- `utils/runtime.py`: `tile_order` equal to JAX's `_tile_order_numpy` on
  every curve, inverted or not, `tile_pixel_batches` equal to JAX's, and
  `bvh_build` equal to JAX's `_bvh_build_numpy` array for array (and, where
  JAX's native builder is built, the same structure and leaf sets as it).
"""

import io
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniraytracer_tpu.ops import mat4 as JM
from miniraytracer_tpu.ops import vecmath as jvm
from miniraytracer_tpu.utils import checkpoint as jck
from miniraytracer_tpu.utils import image as jimage
from miniraytracer_tpu.utils import runtime as jrt
from miniraytracer_tpu.utils import terminal as jterm
from miniraytracer_tpu.utils import tonemap as jtm
from miniraytracer_tpu_torch.ops import mat4 as TM
from miniraytracer_tpu_torch.ops import vecmath as tvm
from miniraytracer_tpu_torch.utils import checkpoint as tck
from miniraytracer_tpu_torch.utils import image as timage
from miniraytracer_tpu_torch.utils import runtime as trt
from miniraytracer_tpu_torch.utils import terminal as tterm
from miniraytracer_tpu_torch.utils import tonemap as ttm

torch.set_num_threads(1)


def _vectors(seed, n=64):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, 3)).astype(np.float32)
    a[0] = 0.0  # a zero vector
    return a


def _unit(seed, n=64):
    a = _vectors(seed, n)
    a[0] = [0.95, 0.1, 0.0]  # |x| > 0.9: the other ONB branch
    return a / np.linalg.norm(a, axis=1, keepdims=True)


VEC_CASES = {
    "dot": lambda m, t: m.dot(t(_vectors(1)), t(_vectors(2))),
    "sdot": lambda m, t: m.sdot(t(_vectors(1))),
    "length": lambda m, t: m.length(t(_vectors(1))),
    "cross": lambda m, t: m.cross(t(_vectors(1)), t(_vectors(2))),
    "normalize": lambda m, t: m.normalize(t(_vectors(1))),
    "reflect": lambda m, t: m.reflect(t(_unit(3)), t(_unit(4))),
    "refract": lambda m, t: m.refract(
        t(_unit(3)), -t(_unit(3)) * 0.6 + t(_unit(4)) * 0.8,
        t(np.linspace(0.5, 2.0, 64, dtype=np.float32))),
    "gamma_correct": lambda m, t: m.gamma_correct(t(_vectors(5))),
    "onb_from_w": lambda m, t: m.onb_from_w(t(_unit(6))),
    "onb_local_to_world": lambda m, t: m.onb_local_to_world(
        t(_unit(1)), t(_unit(2)), t(_unit(3)), t(_vectors(4))),
}


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(y) for y in x]
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("name", sorted(VEC_CASES))
def test_vecmath_helpers_match_jax(name):
    ours = _np(VEC_CASES[name](tvm, torch.from_numpy))
    theirs = _np(VEC_CASES[name](jvm, jnp.asarray))
    for a, b in zip(ours if isinstance(ours, list) else [ours],
                    theirs if isinstance(theirs, list) else [theirs]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_argb32_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    c = rng.uniform(-0.5, 1.5, (256, 3)).astype(np.float32)
    c[:4] = [[1.0, 0.0, 0.5], [2.0, -1.0, 0.25], [1.0, 1.0, 1.0], [0.0, 0.0, 0.0]]
    ours = tvm.argb32(torch.from_numpy(c)).numpy()
    theirs = np.asarray(jvm.argb32(jnp.asarray(c)))
    assert ours.dtype == theirs.dtype == np.uint32
    np.testing.assert_array_equal(ours, theirs)
    assert ours[2] == 0xFFFFFFFF and ours[3] == 0xFF000000


MAT4_CASES = {  # tests/test_mat4.py, each as the arrays it checks
    "identity_and_matmul": lambda M: [M.apply_point(M.translate([1, 2, 3]) @ M.scale(2.0),
                                                    [1, 1, 1])],
    "invert_roundtrip": lambda M: (lambda m: [M.invert(m), m @ M.invert(m)])(
        M.translate([1, -2, 3]) @ M.rotate_axis(0.7, [1, 2, 3]) @ M.scale([2, 3, 4])),
    "rotate_y_matches_reference_sense": lambda M: [
        M.apply_point(M.rotate_y(math.radians(30)), [1, 0, 0]),
        M.apply_point(M.rotate_y(math.radians(30)), [0, 0, 1])],
    "scale_axis_and_reflect": lambda M: [
        M.apply_point(M.scale_axis(3.0, [1, 0, 0]), [1, 1, 0]),
        M.apply_point(M.reflect([0, 1, 0]), [1, 2, 3])],
    "involution": lambda M: [M.apply_point(M.involution([0, 0, 1]), [1, 2, 3])],
    "rotation_preserves_length_and_normal_rule": lambda M: [
        M.apply_vector(M.rotate_axis(1.1, [1, 1, 0]), [1.0, 2.0, 3.0]),
        M.apply_normal(M.rotate_axis(1.1, [1, 1, 0]), [1.0, 2.0, 3.0])],
    "transpose": lambda M: [M.transpose(M.rotate_z(0.3)), M.rotate_x(0.4), M.identity(),
                            M.matmul(M.rotate_x(0.2), M.rotate_z(0.5))],
}


@pytest.mark.parametrize("name", sorted(MAT4_CASES))
def test_mat4_matches_jax(name):
    for a, b in zip(_np(MAT4_CASES[name](TM)), _np(MAT4_CASES[name](JM))):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def _hdr_frame(seed=0, h=16, w=20):
    rng = np.random.default_rng(seed)
    f = rng.lognormal(-1.0, 1.5, (h, w, 3)).astype(np.float32)
    f[3, 4] = [40.0, 35.0, 30.0]  # a light
    f[0, 0] = 0.0
    return f


@pytest.mark.parametrize("op", ["drago", "reinhard", "gamma"])
def test_tonemap_matches_jax(op):
    f = _hdr_frame()
    ours = ttm.OPERATORS[op](torch.from_numpy(f)).numpy()
    theirs = np.asarray(jtm.OPERATORS[op](jnp.asarray(f)))
    assert set(ttm.OPERATORS) == set(jtm.OPERATORS)
    assert ours.dtype == np.float32 and 0.0 <= ours.min() and ours.max() <= 1.0
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-7)


def _display_frame(seed=1, h=13, w=17):
    f = np.random.default_rng(seed).uniform(-0.1, 1.1, (h, w, 3)).astype(np.float32)
    f[0, 0] = [1.0, 0.999, 0.0]
    return f


def test_png_round_trips_and_decodes_as_jax_png(tmp_path):
    f = _display_frame()
    path = str(tmp_path / "ours.png")
    timage.save_png(path, f)
    expect = (np.clip(f[::-1], 0.0, 1.0) * 255.99).astype(np.uint8)
    np.testing.assert_array_equal(timage.read_png(path), expect)
    np.testing.assert_array_equal(timage.read_png(path)[-1, 0], [255, 255, 0])
    try:
        from PIL import Image
    except ImportError:  # the decode by PIL needs PIL; the round trip does not
        return
    jimage.save_png(str(tmp_path / "jax.png"), f)
    with Image.open(path) as ours, Image.open(str(tmp_path / "jax.png")) as theirs:
        assert ours.mode == theirs.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))


def test_read_png_rejects_other_pngs(tmp_path):
    path = str(tmp_path / "x.png")
    timage.save_png(path, _display_frame())
    data = bytearray(open(path, "rb").read())
    data[40] ^= 1  # inside IDAT: the CRC no longer holds
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        timage.read_png(path)
    open(path, "wb").write(b"P6\n1 1\n255\n\0\0\0")
    with pytest.raises(ValueError, match="not a PNG"):
        timage.read_png(path)


def test_ppm_bytes_equal_jax(tmp_path):
    f = _display_frame()
    for flip in (True, False):
        timage.save_ppm(str(tmp_path / "ours.ppm"), f, flip=flip)
        jimage.save_ppm(str(tmp_path / "jax.ppm"), f, flip=flip)
        assert (open(tmp_path / "ours.ppm", "rb").read()
                == open(tmp_path / "jax.ppm", "rb").read())


@pytest.mark.parametrize("bare", [False, True])
def test_checkpoints_load_in_both_packages(tmp_path, bare):
    frame = np.random.default_rng(2).uniform(size=(48, 3)).astype(np.float32)
    cfg = {"width": 8, "height": 6, "scene": 2, "samples": 16, "depth": 3}
    ext = "" if bare else ".npz"
    for save, load, who in ((jck.save_checkpoint, tck.load_checkpoint, "jax"),
                            (tck.save_checkpoint, jck.load_checkpoint, "torch")):
        written = save(str(tmp_path / f"{who}{ext}"), frame, 7, cfg)
        assert written == str(tmp_path / f"{who}.npz") and os.path.exists(written)
        f2, s2, c2 = load(str(tmp_path / f"{who}{ext}"))
        np.testing.assert_array_equal(f2, frame)
        assert (s2, c2) == (7, cfg)
    assert tck.FORMAT_VERSION == jck.FORMAT_VERSION == 1
    assert tck.checkpoint_path("a") == jck.checkpoint_path("a") == "a.npz"


def test_terminal_matches_jax():
    img = np.random.default_rng(3).uniform(size=(37, 53, 3)).astype(np.float32)
    for cols in (2, 40, 96):
        assert tterm.ansi_frame(img, cols) == jterm.ansi_frame(img, cols)
    outs = []
    for mod in (tterm, jterm):
        out = io.StringIO()
        view = mod.LiveView(cols=20, out=out)
        view.update(img, status="pass 1/4")
        view.update(img[::-1], status="pass 2/4")
        view.close()
        outs.append(out.getvalue())
    assert outs[0] == outs[1] and outs[0].count("\x1b[2J") == 1


@pytest.mark.parametrize("kind", [trt.TILE_ROW_MAJOR, trt.TILE_MORTON, trt.TILE_HILBERT])
@pytest.mark.parametrize("invert", [0, trt.TILE_INVERT])
def test_tile_order_equals_jax(kind, invert):
    assert (trt.TILE_ROW_MAJOR, trt.TILE_MORTON, trt.TILE_HILBERT, trt.TILE_INVERT) == (
        jrt.TILE_ROW_MAJOR, jrt.TILE_MORTON, jrt.TILE_HILBERT, jrt.TILE_INVERT)
    for tx, ty in [(1, 1), (5, 4), (16, 16), (13, 7)]:
        ours = trt.tile_order(tx, ty, kind | invert)
        assert ours.dtype == np.int32 and sorted(ours.tolist()) == list(range(tx * ty))
        np.testing.assert_array_equal(ours, jrt._tile_order_numpy(tx, ty, kind | invert))
    np.testing.assert_array_equal(trt.tile_order(13, 7), jrt.tile_order(13, 7))


def test_tile_pixel_batches_equal_jax():
    for w, h, ts, nb in [(50, 34, 8, 6), (24, 20, 8, 8), (17, 16, 32, 8), (16, 16, 1, 3)]:
        ours, theirs = trt.tile_pixel_batches(w, h, ts, n_batches=nb), \
            jrt.tile_pixel_batches(w, h, ts, n_batches=nb)
        assert len(ours) == len(theirs) == nb
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(a, b)


def _random_boxes(n, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    e = rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    return c - e, c + e


def _adversarial_boxes(n=4000):  # tests/test_runtime.py:121
    x = np.geomspace(1.0, 1e-30, n).astype(np.float32)
    bmin = np.stack([x, np.zeros_like(x), np.zeros_like(x)], 1)
    return bmin, bmin + np.float32(1e-6)


BVH_INPUTS = {
    **{f"random_{n}": (lambda n=n: _random_boxes(n), 4) for n in (1, 2, 7, 100, 1000)},
    "identical_centroids": (lambda: (np.zeros((64, 3), np.float32),
                                     np.ones((64, 3), np.float32)), 2),
    "adversarial": (_adversarial_boxes, 4),
}


@pytest.mark.parametrize("name", list(BVH_INPUTS))
def test_bvh_build_equals_jax(name):
    make, leaf = BVH_INPUTS[name]
    bmin, bmax = make()
    ours = trt.bvh_build(bmin, bmax, leaf_size=leaf)
    theirs = jrt._bvh_build_numpy(bmin, bmax, leaf)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if jrt.native_available() and name.startswith("random"):
        # the native build partitions unstably: the same structure and
        # bounds, the same set of primitives in each leaf, where no two
        # centroids tie (as tests/test_runtime.py:66 holds it)
        nb, nm, po = jrt.bvh_build(bmin, bmax, leaf_size=leaf)
        np.testing.assert_allclose(ours[0], nb, atol=1e-5)
        np.testing.assert_array_equal(ours[1], nm)
        for _, first, count, _ in nm:
            if count > 0:
                assert set(ours[2][first:first + count]) == set(po[first:first + count])


def test_bvh_build_rejects_bad_shapes():
    with pytest.raises(ValueError, match="must be"):
        trt.bvh_build(np.zeros((4, 3)), np.zeros((4, 2)))
