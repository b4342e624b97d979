"""rife_tpu_torch's legacy model `hd` against rife_tpu's, on the CPU.

As test_torch_legacy.py for `hdv2` (whose helpers this file uses), with
rife_tpu's `init_hd`; the trio's flownet holds bias-free convs followed
by BatchNorms with non-trivial statistics, which both packages fold at
load.  `hd`'s flow is unidirectional (img1 is warped by -flow), so each
forward makes 8 NHWC warps of C < 8: six at half resolution, two at full.
The scale knob is held to the reference on `hdv2` only: `init_hd` alone
takes ~18 s here, and each scale is another ~5 s compile of `hd_apply`.
"""
import pytest
import torch

from rife_tpu_torch.nn import SEResBlock
from test_torch_legacy import (check_bf16, check_carrier_round_trip,
                               check_forward_f32, check_trio,
                               check_warps_and_layout, init_tree)


@pytest.fixture(scope="module")
def tree():
    return init_tree("hd")


def test_hd_weight_carrier_round_trip(tree):
    sd = check_carrier_round_trip("hd", tree)
    # The same names as hdv2's transposed convs are plain convs here.
    assert tuple(sd["block0.conv1.weight"].shape) == (8, 192, 3, 3)  # (O, I, kh, kw)
    assert tuple(sd["fusionnet.conv.weight"].shape) == (16, 32, 3, 3)
    assert tuple(sd["block0.res0.relu1"].shape) == (1,)
    assert "block0.res0.conv0.weight" not in sd  # identity shortcut
    assert tuple(sd["contextnet.conv1.conv0.weight"].shape) == (32, 32, 3, 3)


def test_hd_engine_matches_reference_f32(tree):
    check_forward_f32("hd", tree, 1.0, min_flow=2.0)


def test_hd_trio_loads_the_same_in_both_packages(tree, tmp_path):
    check_trio("hd", tree, tmp_path / "hd")


def test_hd_bf16_close_to_f32(tree):
    check_bf16("hd", tree)


def test_hd_warps_and_layout():
    check_warps_and_layout("hd", k3=8, k4=8)


def test_se_resblock_shortcut_and_gate():
    """The SE block's shortcut is a bias-free conv only where the width or
    the stride changes, and its gate a single-slope PReLU."""
    same, down = SEResBlock(16, 16, 5, 1), SEResBlock(16, 32, 3, 2)
    assert same.conv0 is None and down.conv0.bias is None
    assert down.fc1.bias is None and down.fc2.bias is None
    assert tuple(down.relu1.shape) == (1,) and tuple(down.relu2.shape) == (32,)
    x = torch.randn(2, 16, 8, 12).contiguous(memory_format=torch.channels_last)
    assert tuple(same(x).shape) == (2, 16, 8, 12)
    assert tuple(down(x).shape) == (2, 32, 4, 6)
