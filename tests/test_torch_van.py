"""The port's VAN-MoE TriSource detector against the JAX package, on the
CPU: the tiny backbone of ``tests/test_torch_lsknet.py`` with VAN's Large
Kernel Attention, the same heads, images and tolerances (1e-4 absolute and
relative; boxes 1e-4 of the image size)."""

import pytest

from test_torch_lsknet import (check_from_flax, check_joint,  # noqa: F401
                               check_simple_test, check_stages, make_pair,
                               one_thread)
from torch_jax_refs import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def pair():
    return make_pair("VAN_moe_MultiInput")


def test_from_flax_round_trip(pair):
    state = check_from_flax(pair)
    assert tuple(state["backbone.stage3_block0.attn.spatial_gating_unit"
                       ".conv1.weight"].shape) == (64, 64, 1, 1)
    assert not any("conv_squeeze" in k for k in state)


def test_backbone_neck_and_head_outputs(pair):
    check_stages(pair)


@pytest.mark.parametrize("which", ["sar", "rgb"])
def test_simple_test_detections(pair, which):
    check_simple_test(pair, which)


def test_simple_test_joint(pair):
    check_joint(pair)
