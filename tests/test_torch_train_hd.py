"""One f32 training step of `hd` in rife_tpu_torch against rife_tpu's
legacy objective, on the CPU (`hdv2` in test_torch_train_hdv2.py).

Charbonnier L1 + ternary census, plus 0.01 x EPE of every block's flow
against the batch's half-resolution flow_gt where it has one (`hd`'s
flow is one direction, 2 channels: f against flow_gt[:, :2] and -f
against [:, 2:4]).  Seeded weights (flow heads x 4,
`train_family_weights`) and batches, 2x64x64; the tolerances of
test_torch_train_objectives.py (loss and metrics 1e-5 relative, every
gradient 1e-3 relative norm).  The NHWC warps' gradient runs the plain
version on the permuted planes, as K1's gradient kernel runs it on the
card: the counts per step must equal `TRAIN_FAMILY_LAUNCHES`, which
chip_smoke.py's phase 16 holds the card to, and its forward warps
rife_tpu's.
"""
import pytest

from test_torch_train_objectives import PortCounts, batch, check_warp_counts, compare_step, weights


@pytest.mark.parametrize("flow_gt", [False, True])
def test_hd_step_matches_reference(monkeypatch, flow_gt):
    counts = PortCounts(monkeypatch)
    m, vis, n, grads = compare_step("hd", weights("hd"), batch(seed=6, flow_gt=flow_gt),
                                    counts)
    assert (float(m["loss_cons"]) > 0) == flow_gt
    assert float(vis["flow"].abs().max()) > 1.0
    check_warp_counts("hd", n, batch(seed=6, flow_gt=flow_gt), monkeypatch)
    still = [k for k, g in grads.items() if float(g.abs().max()) == 0.0]
    assert not still, still
