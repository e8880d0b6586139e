"""Perlin turbulence of the port (`ops/noise.py`, kernel B6's plain version,
and the textures of `models/textures.py`) against the JAX package's.

The same points go through `flash_turbulence_plain` and through JAX's
`textures.perlin_turbulence` and `noise.flash_turbulence(interpret=True)`,
at the JAX package's own tolerances (tests/test_noise.py): 2e-6 on [-9, 9]^3,
2e-5 on [-300, 300]^3, where the lattice cells run negative and N is no
multiple of any block. The tables are equal to the bit, so the port's and
the JAX package's plain sums differ only where XLA rounds another way.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniraytracer_tpu.models import scenes as jscenes
from miniraytracer_tpu.models import textures as jtex
from miniraytracer_tpu.ops import noise as jnoise
from miniraytracer_tpu.ops.vecmath import V3 as JV3
from miniraytracer_tpu_torch.models import scenes as tscenes
from miniraytracer_tpu_torch.models import textures as ttex
from miniraytracer_tpu_torch.ops import noise as tnoise
from miniraytracer_tpu_torch.ops.vecmath import V3

torch.set_num_threads(1)

CASES = [(3, 4096, 9.0, 2e-6), (5, 777, 300.0, 2e-5)]


def _points(seed, n, span):
    pts = np.random.default_rng(seed).uniform(-span, span, (n, 3)).astype(np.float32)
    return (JV3(*(jnp.asarray(pts[:, k]) for k in range(3))),
            V3(*(torch.as_tensor(np.ascontiguousarray(pts[:, k])) for k in range(3))))


def test_noise_tables_equal_jax_lane_tiles():
    """The (6, 256) rows are the JAX kernel's (96, 128) lane tiles unfolded:
    rows 16k and 16k + 8 hold entries [0, 128) and [128, 256) of table k."""
    js, ts = jscenes.perlin_spheres(1.0), tscenes.perlin_spheres(1.0)
    jtab = np.asarray(jnoise.noise_tables(js.perlin_px, js.perlin_py, js.perlin_pz,
                                          js.perlin_vec))
    ttab = tnoise.noise_tables(ts)
    assert ttab.shape == (6, 256) and ttab.dtype == torch.float32
    for k in range(6):
        np.testing.assert_array_equal(
            ttab[k].numpy(), np.concatenate([jtab[16 * k], jtab[16 * k + 8]]))
        assert (jtab[16 * k:16 * k + 8] == jtab[16 * k]).all()


@pytest.mark.parametrize("seed,n,span,atol", CASES)
def test_turbulence_plain_matches_jax(seed, n, span, atol):
    js, ts = jscenes.perlin_spheres(1.0), tscenes.perlin_spheres(1.0)
    jp, tp = _points(seed, n, span)
    got = tnoise.flash_turbulence_plain(tnoise.noise_tables(ts), tp)
    assert got.shape == (n,) and got.dtype == torch.float32
    ref = np.asarray(jtex.perlin_turbulence(js, jp))
    np.testing.assert_allclose(got.numpy(), ref, atol=atol)
    ptab = jnoise.noise_tables(js.perlin_px, js.perlin_py, js.perlin_pz, js.perlin_vec)
    kernel = np.asarray(jnoise.flash_turbulence(ptab, jp, interpret=True))
    np.testing.assert_allclose(got.numpy(), kernel, atol=atol)
    # the textures' entry points take the same function
    np.testing.assert_array_equal(ttex.perlin_turbulence(ts, tp).numpy(), got.numpy())
    # one CPU tensor: the wrapper runs the plain version and launches nothing
    launches = tnoise.launches
    np.testing.assert_array_equal(
        tnoise.flash_turbulence(tnoise.noise_tables(ts), tp).numpy(), got.numpy())
    assert tnoise.launches == launches


def test_turbulence_octave_matches_jax_perlin_noise():
    js, ts = jscenes.perlin_spheres(1.0), tscenes.perlin_spheres(1.0)
    jp, tp = _points(7, 2000, 40.0)
    np.testing.assert_allclose(ttex.perlin_noise(ts, tp).numpy(),
                               np.asarray(jtex.perlin_noise(js, jp)), atol=1e-6)


def test_fast_perlin_matches_jax():
    """Hash gradients: the hashes are integers (equal); the gradient's cube
    root and sin/cos may round another way than XLA's, by an ulp or two."""
    js = dataclasses.replace(jscenes.perlin_spheres(1.0), fast_perlin=True)
    ts = dataclasses.replace(tscenes.perlin_spheres(1.0), fast_perlin=True)
    jp, tp = _points(11, 3000, 50.0)
    ji, ti = (np.array([-300, -1, 0, 1, 255, 256, 1000]) for _ in range(2))
    jg = jtex._hash_gradient(jnp.asarray(ji, jnp.int32), jnp.asarray(ji[::-1], jnp.int32),
                             jnp.asarray(ji * 7, jnp.int32))
    tg = ttex._hash_gradient(torch.as_tensor(ti, dtype=torch.int32),
                             torch.as_tensor(ti[::-1].copy(), dtype=torch.int32),
                             torch.as_tensor(ti * 7, dtype=torch.int32))
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    np.testing.assert_allclose(ttex.perlin_noise(ts, tp).numpy(),
                               np.asarray(jtex.perlin_noise(js, jp)), atol=2e-6)
    got = ttex.perlin_turbulence(ts, tp).numpy()
    np.testing.assert_allclose(got, np.asarray(jtex.perlin_turbulence(js, jp)), atol=5e-6)
    # another realisation than the tables', of the same statistics
    assert not np.allclose(got, tnoise.flash_turbulence_plain(tnoise.noise_tables(ts), tp))


def test_flash_turbulence_checks_its_arguments():
    ts = tscenes.perlin_spheres(1.0)
    _, tp = _points(1, 10, 1.0)
    with pytest.raises(ValueError, match="p.y"):
        tnoise.flash_turbulence(tnoise.noise_tables(ts), V3(tp.x, tp.y[:5], tp.z))
