"""One f32 training step of the objectives of `rife_m`, `rife_2r` and
v4.25 in rife_tpu_torch against rife_tpu's, on the CPU, and what the
training tests of the other presets share (tests/test_torch_train_
{hdv2,hd,resume}.py import it): seeded weights with flows of several
pixels, seeded batches, and `compare_step`: the loss and each metric
against jax.value_and_grad(rife_tpu.train.loop._loss_fn) within 1e-5
relative, every gradient within 1e-3 relative norm per parameter (the
tolerances of tests/test_torch_train.py, whose reasons hold here), the
panel tensors within 2e-4 of their scale.  The port's plain versions are
counted per step as the card's kernels launch (`PortCounts`): the counts
must equal `TRAIN_FAMILY_LAUNCHES`, which chip_smoke.py's phase 16 holds
the card's kernels to, and the forward warps among them rife_tpu's warps
per step (`reference_warps`).

Weights: `train_family_weights` (rife_tpu_torch/tools/train_family.py),
which chip_smoke.py's phase 16 trains on the card: v4.25's in-repo
checkpoint, `rife_m`, `rife_2r`, `hd`, `hdv2` from `ModelDef.init`
(seeded), each block's flow head scaled
(`TRAIN_FAMILY_FLOW_GAIN`, whose comment says why `hd` takes 4 and not
the serving tests' 20) so that the flows reach 2-18 px at 64x64.  At 20,
`hd`'s flows reach ~30 px at 64x64, most taps clamp to the border, the
warped frames go flat, and the legacy objective's census term
(differences of 255-scaled luma, soft-normalised with 0.81) turns so
stiff there that the f32 gradients of either package stray 0.5-1.2% from
an f64 run on single parameters, which no 1e-3 comparison can hold.
Carried to rife_tpu by `jax_tree_from_state_dict(..., model=)`.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rife_tpu.models.registry import MODEL_REGISTRY
from rife_tpu.train.loop import _loss_fn as jax_loss_fn
from rife_tpu_torch.data import SyntheticTriplets, batch_iterator
from rife_tpu_torch.engine import state_dict_from_jax
from rife_tpu_torch.engine.checkpoint import jax_tree_from_state_dict
from rife_tpu_torch.models import get_model_def
from rife_tpu_torch.ops import warp as tw
from rife_tpu_torch.tools.train_family import TRAIN_FAMILY_LAUNCHES, train_family_weights
from rife_tpu_torch.train.loop import loss_fn, train_init

@functools.lru_cache(maxsize=None)
def _weights(model: str) -> dict:
    return train_family_weights(model)


def weights(model: str) -> dict:
    """A copy of the model's test weights (a state dict)."""
    return {k: v.clone() for k, v in _weights(model).items()}


def batch(seed=3, crop=64, n=2, timestep=None, flow_gt=False):
    """A uint8 batch of SyntheticTriplets crops, its timestep replaced by
    `timestep` where given, and a smooth 4-channel flow_gt of a few px at
    half resolution (NHWC f32) with `flow_gt`."""
    b = next(batch_iterator(SyntheticTriplets(n=2 * n, h=crop + 8, w=crop + 8,
                                              seed=seed), n, seed=seed, crop=crop))
    if timestep is not None:
        b["timestep"] = np.asarray(timestep, np.float32).reshape(n)
    if flow_gt:
        rng = np.random.default_rng(seed)
        h = w = crop // 2
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = np.stack([np.sin(yy / 5), np.cos(xx / 7), -np.sin(xx / 6), np.cos(yy / 4)], -1)
        b["flow_gt"] = (3 * base + rng.normal(0, 0.5, (n, h, w, 4))).astype(np.float32)
    return b


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.lru_cache(maxsize=None)
def jax_grad_fn(model: str):
    model_def = MODEL_REGISTRY[model]
    return jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(p, b, model_def, jnp.float32), has_aux=True))


class PortCounts:
    """The port's plain versions counted as the card's kernels launch: K1
    (`warp_planes_ref` called outside K2's and the NHWC warp's plain
    versions), K1's gradient (`warp_planes_bwd_ref`, which the NHWC
    warp's gradient calls too), K2 (`warp2_blend_planes_ref`), K3 and K4
    (`warp_ref`, by C < 8 or >= 8)."""

    def __init__(self, monkeypatch):
        self.n = dict.fromkeys(("warp_planes", "warp_planes_bwd", "warp_blend",
                                "warp_nhwc_k3", "warp_nhwc_k4"), 0)
        self._inside = 0
        ref, blend, nhwc = tw.warp_planes_ref, tw.warp2_blend_planes_ref, tw.warp_ref
        bwd = tw.warp_planes_bwd_ref

        def k1(*a, **k):
            self.n["warp_planes"] += self._inside == 0
            return ref(*a, **k)

        def outer(fn, key):
            def f(*a, **k):
                self.n[key(a) if callable(key) else key] += 1
                self._inside += 1
                try:
                    return fn(*a, **k)
                finally:
                    self._inside -= 1
            return f

        def k1_grad(*a, **k):
            self.n["warp_planes_bwd"] += 1
            return bwd(*a, **k)

        monkeypatch.setattr(tw, "warp_planes_ref", k1)
        monkeypatch.setattr(tw, "warp_planes_bwd_ref", k1_grad)
        monkeypatch.setattr(tw, "warp2_blend_planes_ref", outer(blend, "warp_blend"))
        monkeypatch.setattr(tw, "warp_ref", outer(
            nhwc, lambda a: "warp_nhwc_k3" if a[0].shape[-1] < 8 else "warp_nhwc_k4"))

    def take(self) -> dict:
        out, self.n = self.n, dict.fromkeys(self.n, 0)
        return out


def reference_warps(model: str, b: dict, monkeypatch) -> int:
    """rife_tpu's warps in one training step of `model`: its calls of
    `warp_xla`, which every warp of its XLA path reaches (each
    differentiated once by XLA), counted while value_and_grad of its
    objective traces."""
    jw = importlib.import_module("rife_tpu.ops.warp")  # rife_tpu.ops.warp is a function
    n = [0]
    warp_xla = jw.warp_xla

    def counted(*a, **k):
        n[0] += 1
        return warp_xla(*a, **k)

    monkeypatch.setattr(jw, "warp_xla", counted)
    model_def = MODEL_REGISTRY[model]
    jax.eval_shape(jax.value_and_grad(lambda p, bb: jax_loss_fn(p, bb, model_def, jnp.float32),
                                      has_aux=True),
                   jax_tree_from_state_dict(weights(model), model=model),
                   {k: jnp.asarray(v) for k, v in b.items()})
    return n[0]


def check_warp_counts(model: str, port: dict, b: dict, monkeypatch):
    """The port's launches per step (`PortCounts`) are chip_smoke.py's
    table, and its forward warps (K1 + K3 + K4: v4.25's fifth K1 launch is
    the backward's recompute of the pair its one K2 launch warped) are
    rife_tpu's warps per step."""
    assert port == TRAIN_FAMILY_LAUNCHES[model], port
    fwd = port["warp_planes"] + port["warp_nhwc_k3"] + port["warp_nhwc_k4"]
    assert reference_warps(model, b, monkeypatch) == fwd


def compare_step(model: str, sd: dict, b: dict, counts: PortCounts | None = None):
    """One f32 step of `model`'s objective in both packages on the same
    weights and batch: the loss and each metric within 1e-5 relative, every
    parameter's gradient within 1e-3 relative norm, the panel tensors
    within 2e-4 of their scale.  Returns (the port's metrics, its vis, the
    plain-version counts of the step, its parameters' gradients)."""
    (jloss, (jm, jvis)), jgrads = jax_grad_fn(model)(
        jax_tree_from_state_dict(sd, model=model), {k: jnp.asarray(v) for k, v in b.items()})
    state = train_init(get_model_def(model), total_steps=10, params=sd, device="cpu")
    from rife_tpu_torch.engine.inference import full_f32

    if counts is not None:
        counts.take()
    with full_f32():
        loss, metrics, vis = loss_fn(state.model, b, state.model_def, torch.float32)
        loss.backward()
    step_counts = counts.take() if counts is not None else None
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert sorted(metrics) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    want = state_dict_from_jax(jgrads, model=model)
    named = dict(state.model.named_parameters())
    assert sorted(named) == sorted(want)
    worst = max((rel(named[k].grad.numpy(), want[k].numpy()), k) for k in want)
    assert worst[0] <= 1e-3, worst
    assert sorted(vis) == sorted(jvis)
    for k, v in vis.items():
        got, ref = v.permute(0, 2, 3, 1).numpy(), np.asarray(jvis[k])
        assert got.shape == ref.shape, k
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=2e-4 * max(1.0, float(np.abs(ref).max())), err_msg=k)
    grads = {k: p.grad.clone() for k, p in named.items()}
    return metrics, vis, step_counts, grads


def test_rife_m_step_at_quarter_timestep_matches_reference(monkeypatch):
    """rife_m at t = 0.25 (the batch's timestep reaches the net: t = 0.5
    gives another loss)."""
    counts = PortCounts(monkeypatch)
    sd = weights("rife_m")
    m, vis, n, _ = compare_step("rife_m", sd, batch(seed=3, timestep=[0.25, 0.25]), counts)
    assert float(vis["flow"].abs().max()) > 2.0
    check_warp_counts("rife_m", n, batch(seed=3, timestep=[0.25, 0.25]), monkeypatch)
    st = train_init(get_model_def("rife_m"), total_steps=10, params=sd, device="cpu")
    _, other, _ = loss_fn(st.model, batch(seed=3, timestep=[0.5, 0.5]), st.model_def)
    assert abs(float(other["loss"]) - float(m["loss"])) > 1e-4


def test_rife_2r_step_matches_reference(monkeypatch):
    counts = PortCounts(monkeypatch)
    _, vis, n, _ = compare_step("rife_2r", weights("rife_2r"), batch(seed=4), counts)
    assert float(vis["flow"].abs().max()) > 2.0
    check_warp_counts("rife_2r", n, batch(seed=4), monkeypatch)


def test_v425_step_matches_reference(monkeypatch):
    """v4.25 from its checkpoint (flow heads scaled) at timesteps 0.25 and
    0.7: the final level takes K2's plain version (blend only) and its
    backward the composed pair; rife_tpu composes it on the CPU."""
    counts = PortCounts(monkeypatch)
    _, vis, n, _ = compare_step("v4.25", weights("v4.25"), batch(seed=5, timestep=[0.25, 0.7]),
                                counts)
    assert float(vis["flow"].abs().max()) > 2.0
    check_warp_counts("v4.25", n, batch(seed=5, timestep=[0.25, 0.7]), monkeypatch)
