"""The port's schedules (rife_tpu_torch.engine.schedule) against
rife_tpu's: the same call sequence on a call-recording engine, and the
same frames from real engines on shared weights (f32, 2e-4)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rife_tpu.engine import schedule as ref_schedule
from rife_tpu.engine.inference import InferenceEngine as JaxEngine
from rife_tpu.models.ifnet import IFNetConfig as JaxIFNetConfig
from rife_tpu_torch.engine import InferenceEngine, schedule, state_dict_from_jax

from test_torch_ladder import ATOL, _r5, pair, random_tree

SCHEDULES = ("midpoint_tree", "exp_doubling", "bisect_to_ratio", "timestep_frames")


class Recorder:
    """An engine whose frames are names: interpolate(a, b, t, tta) records
    the call and returns the name of its result."""

    def __init__(self, supports_timestep, model_name="fake"):
        self.supports_timestep = supports_timestep
        self.model_name = model_name
        self.calls = []

    def interpolate(self, a, b, t=0.5, tta=False):
        self.calls.append((a, b, float(t), tta))
        return f"[{a}|{b}@{float(t):g}{'+tta' if tta else ''}]"


def _both(name, timestep_model, *args, **kwargs):
    """Run one schedule in both packages on fresh recorders -> ((calls,
    result) of rife_tpu, of the port); an exception is the result."""
    out = []
    for mod in (ref_schedule, schedule):
        eng = Recorder(timestep_model)
        try:
            res = getattr(mod, name)(eng, *args, **kwargs)
        except ValueError as e:
            res = ("raised", str(e))
        out.append((eng.calls, res))
    return out


CASES = (
    [("midpoint_tree", ("a", "b", n), {"tta": tta}) for n in range(8) for tta in (False, True)]
    + [("exp_doubling", (["a", "b", "c"][:k], p), {"tta": tta})
       for k in (2, 3) for p in range(4) for tta in (False, True)]
    + [("bisect_to_ratio", ("a", "b", r), kw) for r in (0.01, 0.125, 0.3, 0.375, 0.5, 0.7,
                                                         0.99)
       for kw in ({}, {"threshold": 0.001, "max_cycles": 3}, {"tta": True})]
    + [("timestep_frames", ("a", "b", n), {"tta": tta}) for n in range(5)
       for tta in (False, True)]
)


@pytest.mark.parametrize("timestep_model", [False, True], ids=["midpoint", "timestep"])
@pytest.mark.parametrize("name,args,kwargs", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_same_calls_as_reference(name, args, kwargs, timestep_model):
    (ref_calls, ref_res), (calls, res) = _both(name, timestep_model, *args, **kwargs)
    assert calls == ref_calls
    assert res == ref_res


def test_even_midpoint_tree_omits_the_midpoint():
    eng = Recorder(False)
    out = schedule.midpoint_tree(eng, "a", "b", 2)
    mid = "[a|b@0.5]"
    assert out == [f"[a|{mid}@0.5]", f"[{mid}|b@0.5]"]
    assert mid not in out


def test_timestep_frames_refuses_a_fixed_midpoint_model():
    with pytest.raises(ValueError, match="not timestep-conditioned"):
        schedule.timestep_frames(Recorder(False, "rife"), "a", "b", 3)
    assert schedule.timestep_frames(Recorder(False), "a", "b", 1) == ["[a|b@0.5]"]


@pytest.fixture(scope="module")
def engines():
    """(rife_tpu engine, port engine) pairs on shared f32 weights: `rife`
    with r5, `rife_m` with a seeded tree (flow heads x4)."""
    jcfg = JaxIFNetConfig(variant="rife_m")
    tree_m = random_tree(jcfg, seed=21, flow_gain=4.0)
    return {
        "rife": (JaxEngine("rife", _r5()),
                 InferenceEngine("rife", state_dict_from_jax(_r5()), device="cpu")),
        "rife_m": (JaxEngine("rife_m", tree_m),
                   InferenceEngine("rife_m", state_dict_from_jax(tree_m, model="rife_m"),
                                   device="cpu")),
    }


def _frames(out):
    return [np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor)
            else x.float().numpy() for x in out]


REAL = [("rife", "midpoint_tree", 3), ("rife", "exp_doubling", 2),
        ("rife", "bisect_to_ratio", 0.3), ("rife_m", "midpoint_tree", 2),
        ("rife_m", "bisect_to_ratio", 0.3), ("rife_m", "timestep_frames", 3)]


@pytest.mark.parametrize("model,name,arg", REAL, ids=[f"{m}-{n}" for m, n, _ in REAL])
def test_real_engines_match_reference(engines, model, name, arg):
    jeng, teng = engines[model]
    a, b = pair(64, 96, seed=4)
    a, b = a[:1], b[:1]
    if name == "exp_doubling":
        want = ref_schedule.exp_doubling(jeng, [jnp.asarray(a), jnp.asarray(b)], arg)
        got = schedule.exp_doubling(teng, [torch.from_numpy(a), torch.from_numpy(b)], arg)
    else:
        want = getattr(ref_schedule, name)(jeng, jnp.asarray(a), jnp.asarray(b), arg)
        got = getattr(schedule, name)(teng, torch.from_numpy(a), torch.from_numpy(b), arg)
    want, got = (_frames(x) if isinstance(x, list) else _frames([x]) for x in (want, got))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    if model == "rife_m" and name == "timestep_frames":
        assert float(np.abs(got[0] - got[-1]).mean()) > 1e-3  # t reaches the net
