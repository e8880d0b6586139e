"""The port's counter-based RNG against miniraytracer_tpu.ops.rng.

Both packages must draw bit-identical numbers per (pixel, sample, bounce,
slot); the port holds u32 words in int64 tensors (torch has no uint32
add/shift/compare on the CPU), so keys >= 2^31 are covered explicitly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miniraytracer_tpu.ops import rng as jrng
from miniraytracer_tpu_torch.ops import rng as trng

torch.set_num_threads(1)

N = 100_000
EDGE = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1],
                np.uint32)


def _u32(rs, n=N):
    return np.concatenate([EDGE, rs.integers(0, 2**32, n - EDGE.size,
                                             dtype=np.uint64).astype(np.uint32)])


def _t(a):
    return torch.as_tensor(a.astype(np.int64))


def test_hashes_bit_equal():
    rs = np.random.default_rng(0)
    key, data = _u32(rs), _u32(rs)
    slot = rs.integers(0, 64, N).astype(np.uint32)
    assert (key >= 2**31).sum() > N // 3
    checks = {
        "pcg_hash": (jrng.pcg_hash(key), trng.pcg_hash(_t(key))),
        "fold": (jrng.fold(key, data), trng.fold(_t(key), _t(data))),
        "ray_key": (jrng.ray_key(key, data), trng.ray_key(_t(key), _t(data))),
        "bits": (jrng.bits(key, slot), trng.bits(_t(key), _t(slot))),
    }
    for name, (j, t) in checks.items():
        np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("slot", [0, 8, 17, 2**31 + 5])
def test_uniform_bit_equal(slot):
    rs = np.random.default_rng(slot % 1000)
    key = _u32(rs)
    j = np.asarray(jrng.uniform(jnp.asarray(key), np.uint32(slot)))
    t = trng.uniform(_t(key), np.uint32(slot)).numpy()
    assert t.dtype == np.float32
    np.testing.assert_array_equal(j.view(np.uint32), t.view(np.uint32))
    assert t.min() >= 0.0 and t.max() < 1.0


def test_scalar_data_folds_like_jax():
    # the render folds a Python constant (CAM_FOLD) and int32 depths
    rs = np.random.default_rng(3)
    key = _u32(rs, 1000)
    depth = rs.integers(0, 40, 1000).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jrng.fold(key, 0x0C0FFEE)).astype(np.int64),
        trng.fold(_t(key), 0x0C0FFEE).numpy())
    np.testing.assert_array_equal(
        np.asarray(jrng.fold(key, depth)).astype(np.int64),
        trng.fold(_t(key), torch.as_tensor(depth)).numpy())


@pytest.mark.parametrize("seed", [
    (11350390909718046443, 6305599193148252115, False),  # scene stream
    (11350390909718046443, 6305599193148252115, True),  # Perlin G_rng
    (42, 54, False),
])
def test_pcg32_stream_equal(seed):
    a, b = jrng.Pcg32(*seed), trng.Pcg32(*seed)
    assert [a.rand32() for _ in range(2000)] == [b.rand32() for _ in range(2000)]
    assert [a.randf() for _ in range(500)] == [b.randf() for _ in range(500)]
    assert [a.in_ball() for _ in range(200)] == [b.in_ball() for _ in range(200)]


def test_sample_in_disk_within_one_ulp():
    """Points agree within one float32 ulp of the unit radius (2^-24).

    XLA and torch each round sin/cos within one ulp of the true value, so
    the two can differ by one ulp there, and by two ulps of a smaller
    coordinate after the multiply by the radius (0.3% of draws)."""
    rs = np.random.default_rng(7)
    r1 = rs.random(N, dtype=np.float32)
    r2 = rs.random(N, dtype=np.float32)
    j = jrng.sample_in_disk(jnp.asarray(r1), jnp.asarray(r2))
    t = trng.sample_in_disk(torch.as_tensor(r1), torch.as_tensor(r2))
    ulp1 = np.spacing(np.float32(0.5))  # one ulp of values in [0.5, 1)
    for jc, tc in zip(j, t):
        assert np.abs(np.asarray(jc) - tc.numpy()).max() <= ulp1
