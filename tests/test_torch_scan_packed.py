"""The port's packed train step, `make_train_step(fused_ad=False, pack=8,
spp_step=2)`, against the JAX package's, on the scenes and at the
tolerances of tests/test_torch_scan_train.py (which holds the unpacked
step); a file of its own, so that the two sets of JAX compiles run side by
side."""

import pytest

from tests.test_torch_scan_train import CASES, compare_train_steps


@pytest.mark.parametrize("name,sphere_rule", CASES)
def test_packed_train_step_matches_jax(name, sphere_rule):
    compare_train_steps(name, sphere_rule, pack=8, spp_step=2)
