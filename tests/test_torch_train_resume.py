"""Three training steps of v4.25 and of `hdv2` in rife_tpu_torch against
rife_tpu's jitted step with optax.adamw, and their training checkpoints
across both packages, on the CPU.

Each run starts from a checkpoint the port writes: the test weights of
test_torch_train_objectives.py and the AdamW state of a run in progress,
at a step where the model's schedule gives a useful lr (v4.25's warmup +
cosine at its peak, step 2000; `hdv2`'s cyclic lr at its top, step 8000).
The state's first moments are zero and its second moments per parameter
the mean square of a gradient of the objective on a batch of its own, so
an update is nearly linear in its gradient, as from r5's state in
tests/test_torch_train_steps.py.  (From zero second moments, as a fresh
run has, Adam's update is nearly the gradient's sign, and where the
legacy objective's census term leaves elements of a gradient at f32's
rounding their signs differ between any two f32 computations.)  At the model's
weight decay (1e-4), batch 2 at 64x64 (v4.25 on septuplets, so the
timestep varies), f32.  rife_tpu reads that checkpoint with its own
`load_params` and restores it as its CLI does (the saved leaves into the
live optax state, by order): its forward on those parameters must give
the port's loss, which holds only if every tensor is in the reference's
layout for the model (`hdv2`'s transposed flow heads above all).  Each
step's loss within 2e-4 relative and every parameter's change within 1e-3
relative norm after the first step and 1e-2 after the last (the
tolerances of tests/test_torch_train_steps.py), less, element by element,
the f32 spacing of the parameter it was added to (two ulps, as
tests/test_torch_train.py's AdamW check allows): at these lrs a change
of ~1e-6 on a parameter near 1 (v4.25's ResConv betas) is resolved to a
few percent in f32 in either package.  AdamW's first moments, which
carry the gradients unrounded, within the same 1e-3 after the first step
and 1e-2 after the last.  Then each package resumes from the other's checkpoint after step
3 and takes a fourth step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rife_tpu.engine.checkpoint import load_params as jax_load_params
from rife_tpu.engine.checkpoint import save_params as jax_save_params
from rife_tpu.models.registry import MODEL_REGISTRY
from rife_tpu.train import lr as jlr
from rife_tpu.train.loop import TrainState as JaxTrainState
from rife_tpu.train.loop import make_train_step
from rife_tpu_torch.data import SyntheticSeptuplets, SyntheticTriplets, batch_iterator
from rife_tpu_torch.engine import state_dict_from_jax
from rife_tpu_torch.engine.checkpoint import load_train_tree
from rife_tpu_torch.models import get_model_def
from rife_tpu_torch.train import lr as tlr
from rife_tpu_torch.engine.inference import full_f32
from rife_tpu_torch.train.loop import (_set_moments, loss_fn, restore_checkpoint,
                                       save_checkpoint, train_init, train_step)
from test_torch_train_objectives import rel, weights

STEPS, HORIZON, WORLD_SCALE, WD = 3, 20, 2 / 64, 1e-4
START = {"v4.25": 2000, "hdv2": 8000}


def _schedules(model):
    if model == "hdv2":
        return (jlr.cyclic_lr_schedule(world_scale=WORLD_SCALE),
                tlr.cyclic_lr_schedule(world_scale=WORLD_SCALE))
    return (jlr.warmup_cosine_schedule(HORIZON, world_scale=WORLD_SCALE),
            tlr.warmup_cosine_schedule(HORIZON, world_scale=WORLD_SCALE))


def _batches(model):
    ds = (SyntheticSeptuplets if model == "v4.25" else SyntheticTriplets)(
        n=2 * (STEPS + 2), h=72, w=72, seed=8)
    out = list(batch_iterator(ds, 2, seed=8, crop=64, epochs=1))
    assert len(out) == STEPS + 2
    return out


def _change_rel(got, want, before) -> float:
    """Relative norm of the difference of two changes of one parameter,
    each element's difference less two ulps of the parameter."""
    diff = ((got - before) - (want - before)).abs() - 2 * _ulp(want)
    return float(diff.clamp_min(0).double().norm()
                 / (want - before).double().norm().clamp_min(1e-30))


def _ulp(t):
    return torch.from_numpy(np.spacing(np.abs(t.numpy())))


def _jax_state(path, tx):
    """rife_tpu's CLI resume: the saved leaves into the live state."""
    tree, meta = jax_load_params(path)
    params = jax.tree.map(jnp.asarray, tree["params"])
    live = tx.init(params)
    opt = jax.tree.unflatten(jax.tree.structure(live),
                             [jnp.asarray(x) for x in jax.tree.leaves(tree["opt_state"])])
    return JaxTrainState(params=params, opt_state=opt,
                         step=jnp.asarray(tree["step"], jnp.int32)), meta


@pytest.mark.parametrize("model", ["v4.25", "hdv2"])
def test_steps_and_checkpoints_match_reference(tmp_path, model):
    jsched, tsched = _schedules(model)
    tx = optax.adamw(learning_rate=jsched, weight_decay=WD)
    batches = _batches(model)
    if model == "v4.25":
        assert len({float(t) for b in batches for t in b["timestep"]}) > 2

    state = train_init(get_model_def(model), total_steps=HORIZON, weight_decay=WD,
                       schedule=tsched, params=weights(model), device="cpu")
    with full_f32():
        loss_fn(state.model, batches[-1], state.model_def)[0].backward()
    nu = {k: (p.grad ** 2).mean().expand_as(p).clone() for k, p in state.model.named_parameters()}
    _set_moments(state, {k: torch.zeros_like(v) for k, v in nu.items()}, nu, START[model])
    state.optimizer.zero_grad(set_to_none=True)
    start_ckpt = str(tmp_path / "start.rtpu")
    save_checkpoint(state, start_ckpt)
    restore_checkpoint(state, start_ckpt)

    jstate, meta = _jax_state(start_ckpt, tx)
    assert meta == {"model": model, "step": START[model]}
    live = jax.eval_shape(lambda: MODEL_REGISTRY[model].init(
        jax.random.key(0, impl="rbg"), MODEL_REGISTRY[model].config))
    assert jax.tree.structure(live) == jax.tree.structure(jstate.params)
    for a, b in zip(jax.tree.leaves(live), jax.tree.leaves(jstate.params)):
        assert a.shape == b.shape
    step_fn = make_train_step(MODEL_REGISTRY[model], tx)

    ref_params, ref_mu, ref_losses = [], [], []
    for b in batches[:STEPS]:
        jstate, m = step_fn(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        ref_params.append(state_dict_from_jax(jstate.params, model=model))
        ref_mu.append(state_dict_from_jax(jstate.opt_state[0].mu, model=model))
        ref_losses.append(float(m["loss"]))

    before = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    losses, worst, worst_mu = [], [], []
    for b, want, mu in zip(batches, ref_params, ref_mu):
        m = train_step(state, b, torch.float32)
        assert m["lr"] == pytest.approx(float(jsched(state.step - 1)), rel=1e-6)
        losses.append(float(m["loss"]))
        named = list(state.model.named_parameters())
        worst.append(max((_change_rel(p.detach(), want[k], before[k]), k) for k, p in named))
        worst_mu.append(max((rel(state.optimizer.state[p]["exp_avg"], mu[k]), k)
                            for k, p in named))
    assert state.step == START[model] + STEPS
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-4)
    assert worst[0][0] <= 1e-3 and worst[-1][0] <= 1e-2, worst
    assert worst_mu[0][0] <= 1e-3 and worst_mu[-1][0] <= 1e-2, worst_mu
    assert min(float((p.detach() - before[k]).abs().max())
               for k, p in state.model.named_parameters()) > 0

    # Each package resumes from the other's checkpoint for a fourth step.
    port_ckpt, ref_ckpt = str(tmp_path / "port.rtpu"), str(tmp_path / "ref.rtpu")
    save_checkpoint(state, port_ckpt)
    jax_save_params(ref_ckpt, {"params": jax.tree.map(np.asarray, jstate.params),
                               "opt_state": jax.tree.map(np.asarray, jstate.opt_state),
                               "step": np.asarray(int(jstate.step))},
                    meta={"model": model, "step": int(jstate.step)})
    name, params, mu, nu, step = load_train_tree(ref_ckpt)
    assert (name, step) == (model, START[model] + STEPS)
    for k, p in state.model.named_parameters():
        assert rel(p.detach(), params[k]) <= 1e-5, k
    jfrom_port, _ = _jax_state(port_ckpt, tx)
    _, m_ref = step_fn(jfrom_port, {k: jnp.asarray(v) for k, v in batches[STEPS].items()})
    resumed = train_init(get_model_def(model), total_steps=HORIZON, weight_decay=WD,
                         schedule=tsched, device="cpu")
    restore_checkpoint(resumed, ref_ckpt)
    m_port = train_step(resumed, batches[STEPS], torch.float32)
    assert resumed.step == START[model] + STEPS + 1
    np.testing.assert_allclose(float(m_port["loss"]), float(m_ref["loss"]), rtol=2e-4)
