"""Several training steps of rife_tpu_torch against rife_tpu's, on the CPU.

The r5 run (params, optax.adamw state, step 16000) resumed in both
packages with the schedule of a run of 20 steps at batch 16, whose lr
from step 2000 on is the peak, 7.5e-5: what the reference's CLI gives
`--steps 20 --resume` (the port's CLI alike).  f32, full width, the same
2x64x64 batches made from a seed.  The student's validation PSNR on
224x224 synthetic frames falls by tens of dB in a few such steps, and the
reference's own parameters fall as far: restarting a converged run at
the peak lr does this, in both packages.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rife_tpu.engine.checkpoint import load_params as jax_load_params
from rife_tpu.models.registry import MODEL_REGISTRY
from rife_tpu.train import lr as jlr
from rife_tpu.train.loop import TrainState as JaxTrainState
from rife_tpu.train.loop import make_train_step
from rife_tpu_torch.data import SyntheticTriplets, batch_iterator
from rife_tpu_torch.engine import state_dict_from_jax
from rife_tpu_torch.models import get_model_def
from rife_tpu_torch.train.loop import (eval_step, restore_checkpoint, train_init,
                                       train_step)

CKPT = os.path.join(os.path.dirname(__file__), "..", "train_log_r5", "flownet.rtpu")
STEPS, HORIZON, WORLD_SCALE = 3, 20, 16 / 64
PEAK_LR = 3e-4 * WORLD_SCALE


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _reference_run(batches):
    """rife_tpu's jitted train step from the r5 state -> the parameters
    after each step (state dicts) and the losses."""
    tx = optax.adamw(learning_rate=jlr.warmup_cosine_schedule(
        HORIZON, world_scale=WORLD_SCALE), weight_decay=1e-3)
    tree, _ = jax_load_params(CKPT)
    params = jax.tree.map(jnp.asarray, tree["params"])
    live = tx.init(params)
    state = JaxTrainState(
        params=params,
        opt_state=jax.tree.unflatten(jax.tree.structure(live),
                                     [jnp.asarray(x) for x in
                                      jax.tree.leaves(tree["opt_state"])]),
        step=jnp.asarray(tree["step"], jnp.int32))
    step_fn = make_train_step(MODEL_REGISTRY["rife"], tx)
    params_after, losses = [], []
    for b in batches:
        state, m = step_fn(state, {k: jnp.asarray(v) for k, v in b.items()})
        params_after.append(state_dict_from_jax(state.params))
        losses.append(float(m["loss"]))
    return params_after, losses


def test_steps_from_r5_at_peak_lr_match_reference():
    """Each step's loss within 2e-4 relative (one step's loss agrees to
    1e-5, and each update then carries the gradients' 1e-3 differences
    into the next); every parameter's change within 1e-3 in relative norm
    per leaf after the first step and 1e-2 after the last (the differences
    grow by ~1.6x a step: AdamW divides by the square root of r5's second
    moment, which is tiny for many parameters); the student's validation
    PSNR on the port's and the reference's final parameters within
    0.05 dB, and more than 10 dB below where it started."""
    batches = list(batch_iterator(SyntheticTriplets(n=2 * STEPS, h=72, w=72, seed=4),
                                  2, seed=4, crop=64, epochs=1))
    assert len(batches) == STEPS
    ref_params, ref_losses = _reference_run(batches)

    state = train_init(get_model_def("rife"), total_steps=HORIZON,
                       world_scale=WORLD_SCALE, device="cpu")
    restore_checkpoint(state, CKPT)
    val = next(batch_iterator(SyntheticTriplets(n=2, h=224, w=224, seed=7), 2,
                              crop=224, augment=False, epochs=1))

    def psnr():
        return eval_step(state.model, val, state.model_def)["psnr"].numpy()

    psnr_r5 = psnr()
    before = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    losses, worst = [], []
    for b, want in zip(batches, ref_params):
        m = train_step(state, b, torch.float32)
        assert m["lr"] == pytest.approx(PEAK_LR, rel=1e-12)
        losses.append(float(m["loss"]))
        worst.append(max((_rel(p.detach() - before[k], want[k] - before[k]), k)
                         for k, p in state.model.named_parameters()))
    assert state.step == 16000 + STEPS
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-4)
    assert worst[0][0] <= 1e-3 and worst[-1][0] <= 1e-2, worst

    psnr_port = psnr()
    state.model.load_state_dict(ref_params[-1])
    psnr_ref = psnr()
    print(f"losses {losses} (reference {ref_losses}); worst parameter change "
          f"{worst}; validation PSNR r5 {psnr_r5}, port {psnr_port}, "
          f"reference {psnr_ref} dB")
    np.testing.assert_allclose(psnr_port, psnr_ref, rtol=0, atol=0.05)
    assert np.all(psnr_ref < psnr_r5 - 10), (psnr_r5, psnr_ref)
