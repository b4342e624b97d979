"""rife_tpu_torch training against rife_tpu's, on the CPU.

Same weights (the r5 checkpoint), same seeded numpy inputs and batches in
both packages.  Tolerances: ops that sum in the same order <= 1e-6; the
one-step loss at full width <= 1e-5 relative and every parameter's
gradient <= 1e-3 in relative norm per leaf (the nets sum ~60
convolutions in other orders, and the distillation mask, PReLU and |.|
are kinks where a rounding can flip a branch, so gradients are compared
by leaf norm, not element by element); one AdamW update <= 1e-6
relative.
"""
import functools
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rife_tpu.data import SyntheticTriplets as JaxSynthetic
from rife_tpu.data import VimeoTriplets as JaxVimeo
from rife_tpu.data import batch_iterator as jax_batches
from rife_tpu.engine.checkpoint import load_params as jax_load_params
from rife_tpu.models.ifnet import init_ifnet
from rife_tpu.nn import init as jinit
from rife_tpu.models.registry import MODEL_REGISTRY
from rife_tpu.ops import pyramid as jpyr
from rife_tpu.train import lr as jlr
from rife_tpu.train.loop import _loss_fn as jax_loss_fn
from rife_tpu_torch.cli import train as cli
from rife_tpu_torch.data import SyntheticTriplets, VimeoTriplets, batch_iterator
from rife_tpu_torch.data.vimeo import _PrefetchIterator
from rife_tpu_torch.engine import load_checkpoint, state_dict_from_jax
from rife_tpu_torch.models import get_model_def
from rife_tpu_torch.ops import pyramid as tpyr
from rife_tpu_torch.train import lr as tlr
from rife_tpu_torch.train.loop import (apply_gradients, loss_fn, restore_checkpoint,
                                       save_checkpoint, train_init)

CKPT = os.path.join(os.path.dirname(__file__), "..", "train_log_r5", "flownet.rtpu")


@functools.lru_cache(maxsize=1)
def _r5_params():
    return load_checkpoint(CKPT)[1]


def _planes(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_pyramid_and_lap_loss_match_reference():
    rng = np.random.default_rng(0)
    x = rng.random((2, 64, 96, 3), np.float32)
    y = rng.random((2, 64, 96, 3), np.float32)
    got = tpyr.gauss_blur(_planes(x), 4.0).permute(0, 2, 3, 1).numpy()
    want = jax.jit(lambda a: jpyr.gauss_blur(a, 4.0))(jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
    for g, w in zip(tpyr.laplacian_pyramid(_planes(x), 5),
                    jax.jit(lambda a: jpyr.laplacian_pyramid(a, 5))(jnp.asarray(x))):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   rtol=0, atol=1e-6)
    want = float(jax.jit(jpyr.lap_loss)(jnp.asarray(x), jnp.asarray(y)))
    assert abs(float(tpyr.lap_loss(_planes(x), _planes(y))) - want) <= 1e-6 * want


@pytest.mark.parametrize("total", [5000, 300000])
def test_schedules_match_reference(total):
    steps = (0, 1, 1999, 2000, 2001, total, total + 7)
    want = jlr.warmup_cosine_schedule(total, world_scale=0.25)
    got = tlr.warmup_cosine_schedule(total, world_scale=0.25)
    assert got(0) == 0.0
    for s in steps:
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6, err_msg=str(s))
    want, got = jlr.cyclic_lr_schedule(world_scale=0.5), tlr.cyclic_lr_schedule(world_scale=0.5)
    for s in steps + (8000, 12000, 16001):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6, err_msg=str(s))


def _batch(seed=3):
    return next(batch_iterator(SyntheticTriplets(n=4, h=72, w=72, seed=seed), 2,
                               seed=seed, crop=64))


def test_train_step_loss_and_grads_match_reference():
    """One step of the `rife` objective at full width with the r5 weights
    on 2x64x64, f32: jax.value_and_grad(rife_tpu.train.loop._loss_fn)
    (exact XLA warps) against the port's loss and autograd through its
    warp Function (plain backward on the CPU)."""
    batch = _batch()
    model_def = MODEL_REGISTRY["rife"]
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(p, b, model_def, jnp.float32), has_aux=True))
    (jloss, (jmetrics, _)), jgrads = grad_fn(
        _r5_params(), {k: jnp.asarray(v) for k, v in batch.items()})

    state = train_init(get_model_def("rife"), total_steps=10,
                       params=state_dict_from_jax(_r5_params()), device="cpu")
    loss, metrics, _ = loss_fn(state.model, batch, state.model_def, torch.float32)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k in ("loss_l1", "loss_tea", "loss_distill"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5,
                                   err_msg=k)
    want = state_dict_from_jax(jgrads)
    named = dict(state.model.named_parameters())
    assert sorted(named) == sorted(want)
    worst = max((_rel(named[k].grad.numpy(), want[k].numpy()), k) for k in want)
    assert worst[0] <= 1e-3, worst


def test_adamw_update_matches_optax():
    """One update from the r5 optimizer state (count 16000) and the same
    gradients: optax.adamw's tx.update against the port's AdamW, for the
    parameters and both moments."""
    tree, _ = jax_load_params(CKPT)
    total = 300000
    tx = optax.adamw(learning_rate=jlr.warmup_cosine_schedule(total, world_scale=0.25),
                     weight_decay=1e-3)
    params = jax.tree.map(jnp.asarray, tree["params"])
    live = tx.init(params)
    opt_state = jax.tree.unflatten(jax.tree.structure(live),
                                   [jnp.asarray(x) for x in jax.tree.leaves(tree["opt_state"])])
    rng = np.random.default_rng(5)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(0, 1e-3, p.shape).astype(np.float32)), params)

    @jax.jit
    def update(grads, opt_state, params):
        updates, new_opt = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_opt

    new_params, new_opt = update(grads, opt_state, params)

    state = train_init(get_model_def("rife"), total_steps=total, world_scale=0.25,
                       params=state_dict_from_jax(_r5_params()), device="cpu")
    restore_checkpoint(state, CKPT)
    assert state.step == 16000
    g = state_dict_from_jax(grads)
    old = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        p.grad = g[name]
    lr = apply_gradients(state)
    np.testing.assert_allclose(
        lr, float(jlr.warmup_cosine_schedule(total, world_scale=0.25)(16000)), rtol=1e-6)
    assert state.step == 16001
    want = {"params": state_dict_from_jax(new_params),
            "exp_avg": state_dict_from_jax(new_opt[0].mu),
            "exp_avg_sq": state_dict_from_jax(new_opt[0].nu)}
    for name, p in state.model.named_parameters():
        st = state.optimizer.state[p]
        assert _rel(p.detach(), want["params"][name]) <= 1e-6, name
        # The update itself, element by element, to the f32 resolution of
        # the parameter it was added to (one ulp each side) and 1e-5 of it.
        got_d = (p.detach() - old[name]).numpy()
        want_d = (want["params"][name] - old[name]).numpy()
        lim = 2 * np.spacing(np.abs(want["params"][name].numpy())) + 1e-5 * np.abs(want_d)
        assert np.all(np.abs(got_d - want_d) <= lim), name
        for k in ("exp_avg", "exp_avg_sq"):
            assert _rel(st[k], want[k][name]) <= 1e-6, (name, k)


def test_checkpoint_written_by_the_port_reads_in_the_reference(tmp_path):
    """The r5 training checkpoint resumed by the port and saved again reads
    with rife_tpu's load_params into the same keys, dtypes and values."""
    state = train_init(get_model_def("rife"), total_steps=10,
                       params=state_dict_from_jax(_r5_params()), device="cpu")
    restore_checkpoint(state, CKPT)
    out = str(tmp_path / "flownet.rtpu")
    save_checkpoint(state, out)
    got, meta = jax_load_params(out)
    want, want_meta = jax_load_params(CKPT)
    assert meta == want_meta == {"model": "rife", "step": 16000}
    la = jax.tree_util.tree_leaves_with_path(got)
    lb = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in la] == [p for p, _ in lb] and len(la) == 573
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=str(path))


def test_batches_match_reference():
    a = jax_batches(JaxSynthetic(n=10, h=72, w=80, seed=2), 4, seed=5, crop=64, u8=True)
    b = batch_iterator(SyntheticTriplets(n=10, h=72, w=80, seed=2), 4, seed=5, crop=64)
    for _ in range(4):  # crosses an epoch
        x, y = next(a), next(b)
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_vimeo_reader_matches_reference(tmp_path):
    import cv2

    rng = np.random.default_rng(1)
    items = [f"{i:05d}/0001" for i in range(20)]
    for it in items:
        os.makedirs(tmp_path / "sequences" / it)
        for k in (1, 2, 3):
            cv2.imwrite(str(tmp_path / "sequences" / it / f"im{k}.png"),
                        rng.integers(0, 256, (40, 56, 3), dtype=np.uint8))
    (tmp_path / "tri_trainlist.txt").write_text("\n".join(items) + "\n")
    (tmp_path / "tri_testlist.txt").write_text("\n".join(items[:3]) + "\n")
    for split in ("train", "validation", "test"):
        mine, ref = VimeoTriplets(str(tmp_path), split), JaxVimeo(str(tmp_path), split)
        assert mine.items == ref.items and len(mine) == len(ref)
    mine, ref = VimeoTriplets(str(tmp_path), "train"), JaxVimeo(str(tmp_path), "train")
    x = next(jax_batches(ref, 4, seed=9, crop=32, u8=True))
    y = next(batch_iterator(mine, 4, seed=9, crop=32))
    for k in x:
        np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_init_draws_torch_default_bounds():
    """ModelDef.init: the reference's keys and shapes; every conv weight
    within sqrt(1/fan_in), every bias within 1/sqrt(fan_in), with torch's
    fan-in of the raw weight (a transposed conv's out * k * k, the quirk
    rife_tpu/nn/init.py reproduces, checked on its own draws here);
    PReLU slopes 0.25; the same seed, the same draws."""
    sd = get_model_def("rife").init(torch.Generator().manual_seed(0))
    again = get_model_def("rife").init(torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(init_ifnet, jax.random.PRNGKey(0))
    ref = state_dict_from_jax(jax.tree.map(lambda t: np.zeros(t.shape, np.float32),
                                           shapes))
    assert sorted(sd) == sorted(ref)
    key = jax.random.PRNGKey(1)
    jdraws = {"conv": state_dict_from_jax({"conv": jinit.init_conv(key, 3, 3, 17, 64)}),
              "lastconv": state_dict_from_jax({"lastconv": jinit.init_conv_transpose(
                  key, 4, 90, 5)})}

    def bound(w, leaf):
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        return fan_in ** -0.5 if leaf == "bias" else (1.0 / fan_in) ** 0.5

    for d in jdraws.values():
        for k, v in d.items():
            w = d[k.rsplit(".", 1)[0] + ".weight"]
            m, b = float(v.abs().max()), bound(w, k.rsplit(".", 1)[1])
            assert m <= b * (1 + 1e-6) and (v.numel() < 1000 or m >= 0.95 * b), k
    for k, v in sd.items():
        torch.testing.assert_close(v, again[k], rtol=0, atol=0)
        assert v.shape == ref[k].shape, k
        if k.endswith("alpha"):
            assert bool((v == 0.25).all()), k
            continue
        b = bound(sd[k.rsplit(".", 1)[0] + ".weight"], k.rsplit(".", 1)[1])
        assert float(v.abs().max()) <= b * (1 + 1e-6), k
        if v.numel() >= 1000:
            assert float(v.abs().max()) >= 0.95 * b, k


def test_cli_trains_writes_and_resumes_on_cpu(tmp_path):
    log_dir = str(tmp_path / "log")
    argv = ["--synthetic", "--steps", "2", "--batch_size", "2", "--crop", "32",
            "--device", "cpu", "--log_dir", log_dir]
    cli.main(argv)
    lines = open(os.path.join(log_dir, "metrics.jsonl")).read().splitlines()
    assert len(lines) == 1 and '"step": 1' in lines[0]
    tree, meta = jax_load_params(os.path.join(log_dir, "flownet.rtpu"))
    assert meta["step"] == 2 and int(tree["opt_state"][0][0]) == 2
    # --steps is the total, as in the reference: resumed at 2, 3 trains one.
    cli.main(argv[:2] + ["3"] + argv[3:] + ["--resume", os.path.join(log_dir, "flownet.rtpu")])
    assert jax_load_params(os.path.join(log_dir, "flownet.rtpu"))[1]["step"] == 3


@pytest.mark.parametrize("flag", [["--steps_per_call", "2"]])
def test_cli_refuses_unported_flags(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.parse_args(["--synthetic"] + flag)


@pytest.mark.parametrize("model,flags,wd,crop", [
    ("hdv2", ["--septuplet"], 1e-4, 64),
    ("v4.25", ["--septuplet", "--vis_interval", "1"], 1e-4, 96),
    ("hd", ["--vis_interval", "1", "--weight_decay", "0.01"], 0.01, 64),
    ("rife_m", ["--septuplet"], 1e-3, 64),
    ("rife_2r", [], 1e-3, 64),
])
def test_cli_trains_each_model_on_cpu(tmp_path, monkeypatch, capsys, model, flags, wd, crop):
    """2 steps of batch 2: the model's weight decay (1e-4 for v4.25 and the
    legacy models unless given), its schedule (the legacy models' cyclic
    lr), the crop snapped to its pad multiple (v4.25: 96 -> 64), the
    objective's metrics, panels on steps 1 and 2 with --vis_interval 1
    (step 1 only by default, --vis_interval 1000), the checkpoint under the model's
    name; septuplets for a model without a timestep get the reference's
    note."""
    seen = {}
    init = cli.train_init

    def spy(model_def, **kw):
        seen.update(kw)
        return init(model_def, **kw)

    monkeypatch.setattr(cli, "train_init", spy)
    log_dir = tmp_path / "log"
    cli.main(["--model", model, "--synthetic", "--steps", "2", "--batch_size", "2",
              "--crop", str(crop), "--device", "cpu", "--workers", "0",
              "--log_dir", str(log_dir)] + flags)
    out = capsys.readouterr().out
    assert seen["weight_decay"] == wd
    legacy = model in ("hd", "hdv2")
    assert (seen["schedule"] is not None) == legacy
    if legacy:
        assert seen["schedule"](1) == pytest.approx(
            float(jlr.cyclic_lr_schedule(world_scale=2 / 64.0)(1)), rel=1e-6)
    assert (f"crop {crop} -> 64" in out) == (crop != 64)
    rec = json.loads(open(log_dir / "metrics.jsonl").read().splitlines()[0])
    keys = {"v4.25": ("loss_l1", "loss_smooth"), "hd": ("loss_ter", "loss_cons"),
            "hdv2": ("loss_ter", "loss_cons"), "rife_m": ("loss_tea", "loss_distill"),
            "rife_2r": ("loss_tea", "loss_distill")}
    assert rec["step"] == 1 and all(np.isfinite(rec[k]) for k in ("loss",) + keys[model])
    pngs = sorted(p.relative_to(log_dir).as_posix() for p in log_dir.rglob("*.png"))
    steps = (1, 2) if "--vis_interval" in flags else (1,)
    assert pngs == sorted(f"panels/step_{s:08d}/{i}_{k}.png" for s in steps
                          for i in (0, 1) for k in ("img", "flow", "mask"))
    tree, meta = jax_load_params(str(log_dir / "flownet.rtpu"))
    assert meta == {"model": model, "step": 2}
    assert ("no timestep input" in out) == (
        model not in ("rife_m", "v4.25") and "--septuplet" in flags)


def test_cli_logs_the_lr_the_reference_logs(tmp_path):
    """The lr logged at step s is the schedule at s (rife_tpu/cli/train.py
    logs `schedule(s)` for the step s just finished), not the lr of that
    step's update, schedule(s - 1), which is 0.0 at step 1.  Step 200 is
    reached by resuming a state saved at step 199."""
    log_dir = tmp_path / "log"
    base = ["--synthetic", "--batch_size", "2", "--crop", "32", "--device", "cpu",
            "--workers", "0", "--prefetch", "0", "--log_dir", str(log_dir)]
    cli.main(base + ["--steps", "1"])
    st = train_init(get_model_def("rife"), total_steps=200, device="cpu")
    st.step = 199
    save_checkpoint(st, str(tmp_path / "s199.rtpu"))
    cli.main(base + ["--steps", "200", "--resume", str(tmp_path / "s199.rtpu")])
    recs = [json.loads(x) for x in open(log_dir / "metrics.jsonl").read().splitlines()]
    assert [r["step"] for r in recs] == [1, 200]
    for r, total in zip(recs, (1, 200)):
        want = float(jlr.warmup_cosine_schedule(total, world_scale=2 / 64.0)(r["step"]))
        assert r["lr"] == pytest.approx(want, rel=1e-6), r
    assert recs[0]["lr"] > 0.0


@pytest.mark.parametrize("workers,prefetch", [(0, 0), (4, 0), (0, 2), (4, 2)])
def test_batches_do_not_depend_on_workers_or_prefetch(workers, prefetch):
    """The first 3 batches (crossing an epoch) are bit-identical to the
    reference's for every loader setting: the augment draws are keyed by
    (seed, epoch, slot), not by the thread that makes them."""
    ref = jax_batches(JaxSynthetic(n=10, h=72, w=80, seed=2), 4, seed=5, crop=64,
                      u8=True)
    it = batch_iterator(SyntheticTriplets(n=10, h=72, w=80, seed=2), 4, seed=5,
                        crop=64, workers=workers, prefetch=prefetch)
    assert isinstance(it, _PrefetchIterator) == (prefetch > 0)
    try:
        for _ in range(3):
            x, y = next(ref), next(it)
            for k in x:
                assert x[k].dtype == y[k].dtype, k
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    finally:
        it.close()


def test_prefetch_passes_exceptions_on_and_close_stops_its_thread():
    def failing():
        yield 1
        raise KeyError("bad item")

    it = _PrefetchIterator(failing(), depth=2)
    assert next(it) == 1
    with pytest.raises(KeyError, match="bad item"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)
    it.close()

    def endless():
        i = 0
        while True:
            yield i
            i += 1

    it = _PrefetchIterator(endless(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert not it._thread.is_alive()
    assert not any(t is it._thread for t in threading.enumerate())


def test_cli_accepts_the_reference_loader_and_warp_flags():
    args = cli.parse_args(["--synthetic", "--workers", "4", "--prefetch", "3",
                           "--warp_impl", "pallas"])
    assert (args.workers, args.prefetch, args.warp_impl) == (4, 3, "pallas")
    args = cli.parse_args(["--synthetic"])
    assert (args.workers, args.prefetch, args.warp_impl) == (8, 2, "auto")
    for impl in ("auto", "xla"):
        assert cli.parse_args(["--warp_impl", impl]).warp_impl == impl
