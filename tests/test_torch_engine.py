"""rife_tpu_torch InferenceEngine vs rife_tpu's, and the port's isolation.

On the CPU, with the r5 checkpoint at 128x192: the f32 engines agree to
2e-4 abs at rung 1 (the serving default) and rung 0, and the port's bf16
output stays at >= 40 dB PSNR against its own f32 output.
"""
import ast
import os
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rife_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from rife_tpu.engine.inference import InferenceEngine as JaxEngine
from rife_tpu_torch.engine import InferenceEngine, load_checkpoint, state_dict_from_jax
from rife_tpu_torch.engine.inference import full_f32

ROOT = Path(__file__).resolve().parents[1]
CKPT = os.path.join(ROOT, "train_log_r5", "flownet.rtpu")


def _smooth_pair(batch, h, w, shift, seed=7):
    """Textured smooth content panned by `shift` px (bench.py's recipe)."""
    rng = np.random.default_rng(seed)
    m = max(16, shift + 8)
    base = rng.random((batch, h + 2 * m, w + 2 * m, 3)).astype(np.float32)
    for _ in range(3):
        base = (base + np.roll(base, 1, 1) + np.roll(base, 1, 2)
                + np.roll(base, 2, 1) + np.roll(base, 2, 2)) / 5
    a = base[:, m:m + h, m:m + w]
    b = base[:, m + shift:m + shift + h, m + shift:m + shift + w]
    return np.ascontiguousarray(a), np.ascontiguousarray(b)


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-20))


@pytest.fixture(scope="module")
def r5_state_dict():
    return state_dict_from_jax(load_checkpoint(CKPT)[1])


@pytest.mark.parametrize("fast,scale", [(1, 1.0), (0, 1.0), (1, 0.5)])
def test_engine_matches_reference_f32(r5_state_dict, fast, scale):
    a, b = _smooth_pair(2, 128, 192, 6)
    _, jparams = jax_load_checkpoint(CKPT)
    jeng = JaxEngine("rife", jparams, compute_dtype=jnp.float32, fast=fast,
                     scale=scale, warp_impl="xla")
    want = jeng.interpolate(jnp.asarray(a), jnp.asarray(b))
    eng = InferenceEngine("rife", r5_state_dict, compute_dtype=torch.float32,
                          fast=fast, scale=scale, device="cpu")
    got = eng.interpolate(a, b)
    assert got.shape == (2, 128, 192, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-4)
    assert eng.pad_multiple == jeng.pad_multiple
    assert not eng.supports_timestep


def test_engine_bf16_close_to_own_f32(r5_state_dict):
    a, b = _smooth_pair(2, 128, 192, 6, seed=8)
    ref = InferenceEngine("rife", r5_state_dict, fast=1, device="cpu").interpolate(a, b)
    got = InferenceEngine("rife", r5_state_dict, compute_dtype=torch.bfloat16,
                          fast=1, device="cpu").interpolate_batch(a, b)
    assert got.dtype == torch.bfloat16
    assert _psnr(got.float().numpy(), ref.numpy()) >= 40.0


def test_v425_refuses_scales_other_than_even_integers_in_both_packages():
    """What both packages still refuse: v4.25's levels take 1 or even
    integers only (rife_tpu/models/v425.py:202 asserts it at trace)."""
    import functools

    import jax

    from rife_tpu.models.v425 import V425Config as JaxV425Config
    from rife_tpu.models.v425 import init_v425, v425_apply
    from rife_tpu_torch.models import get_model_def

    odd = tuple(s / 0.75 for s in (16.0, 8.0, 4.0, 2.0, 1.0))
    shapes = jax.eval_shape(lambda k: init_v425(k, JaxV425Config()), jax.random.PRNGKey(0))
    z = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    with pytest.raises(AssertionError):
        jax.eval_shape(functools.partial(v425_apply, scale_list=odd), shapes, z, z)
    sd = get_model_def("v4.25").init(torch.Generator().manual_seed(0))
    eng = InferenceEngine("v4.25", sd, scale=0.75, device="cpu")
    assert eng.scale_list == odd
    with pytest.raises(ValueError, match="even integers"):
        eng.interpolate(np.zeros((1, 64, 64, 3), np.float32),
                        np.zeros((1, 64, 64, 3), np.float32))


def _tf32_flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


def test_f32_call_keeps_tf32_off_while_another_thread_leaves_full_f32(r5_state_dict):
    """The TF32 flags are process-wide.  Another thread enters `full_f32`
    before an f32 request and leaves it while the request runs (between
    its blocks); the request must still see TF32 off at every block, and
    the flags come back as they were once both are done."""
    saved = _tf32_flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        eng = InferenceEngine("rife", r5_state_dict, fast=0, device="cpu")
        entered, leave, left = threading.Event(), threading.Event(), threading.Event()

        def other():
            with full_f32():
                entered.set()
                leave.wait(30)
            left.set()

        seen = []

        def record(*_):
            seen.append(_tf32_flags())

        def let_the_other_leave(*_):
            leave.set()
            assert left.wait(30)
            record()

        hooks = [eng.model.block0.register_forward_pre_hook(record),
                 eng.model.block1.register_forward_pre_hook(let_the_other_leave)]
        hooks += [getattr(eng.model, m).register_forward_pre_hook(record)
                  for m in ("block2", "contextnet", "unet")]
        th = threading.Thread(target=other)
        th.start()
        assert entered.wait(30)
        a, b = _smooth_pair(1, 64, 64, 2)
        eng.interpolate(a, b)
        th.join(30)
        for h in hooks:
            h.remove()
        assert left.is_set() and len(seen) == 5
        assert all(s == (False, False) for s in seen), seen
        assert _tf32_flags() == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_full_f32_keeps_tf32_off_for_every_thread_inside():
    """Stress: more threads than cores enter and leave `full_f32` with a
    short switch interval; each sees TF32 off at every check while inside,
    and the flags come back as they were once all have left."""
    saved = _tf32_flags()
    interval = sys.getswitchinterval()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    seen_on = []

    def worker():
        for _ in range(300):
            with full_f32():
                for _ in range(3):
                    if _tf32_flags() != (False, False):
                        seen_on.append(_tf32_flags())

    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=worker) for _ in range(4 * (os.cpu_count() or 4))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
        assert not seen_on, seen_on[:3]
        assert _tf32_flags() == (True, True)
    finally:
        sys.setswitchinterval(interval)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _imports(path):
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_rife_tpu():
    files = sorted((ROOT / "rife_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "examples" / "demo_torch.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "rife_tpu", "flax", "optax"), (f, mod)
