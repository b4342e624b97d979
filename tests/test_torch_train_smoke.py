"""The loss-decrease check that chip_smoke.py makes on the card, run on
the CPU in f32: from a random init at lr 2e-4, 20 steps on one fixed
2x64x64 batch must bring the mean of the last 5 losses to at most 0.9 of
the first 5's.  The true gradient passes it; a zeroed or a negated one
fails it, so the check tells a broken update.
"""
import pytest
import torch

from rife_tpu_torch.data import SyntheticTriplets, batch_iterator
from rife_tpu_torch.models import get_model_def
from rife_tpu_torch.train import loop
from rife_tpu_torch.train.loop import train_init, train_step


def _mean(xs):
    return sum(xs) / len(xs)


@pytest.mark.parametrize("update", ["gradient", "zeroed", "negated"])
def test_fixed_batch_loss_check_needs_the_true_gradient(update, monkeypatch):
    if update != "gradient":
        apply = loop.apply_gradients

        def broken(state):
            for p in state.model.parameters():
                p.grad.mul_(0.0 if update == "zeroed" else -1.0)
            return apply(state)

        monkeypatch.setattr(loop, "apply_gradients", broken)
    state = train_init(get_model_def("rife"), total_steps=20,
                       schedule=lambda step: 2e-4, seed=0, device="cpu")
    fixed = next(batch_iterator(SyntheticTriplets(n=16, h=72, w=72), 2, crop=64))
    curve = [float(train_step(state, fixed, torch.float32)["loss"]) for _ in range(20)]
    ratio = _mean(curve[-5:]) / _mean(curve[:5])
    assert (ratio <= 0.9) == (update == "gradient"), (ratio, curve)
