"""rife_tpu_torch's gather probes (`ops.gather_probe`, the plain versions of
K6-K8) against the round-3 TPU experiments they port, on the CPU.

tools/r3_exp1.py, r3_exp2.py and r3_exp21.py run their whole benchmark
when imported, so they are never imported or exec'd whole: `_script` parses
a script and executes only the function definitions (and, for
`sel_kernel`, the one `pallas_call` statement) it is asked for, in a
namespace whose constants (R, OUTER, UNROLL, NT, ...) the test sets
small.  The bodies are the scripts' own lambdas, taken from their
`bench(...)` calls and body lists.  None of their `pallas_call`s takes
`interpret=`, so each runs under `pltpu.force_tpu_interpret_mode()`.
Inputs come from a seeded numpy generator.  r3_exp1.py's `unpack` closes
over the module-level `MASK_HI`, which is given as an np.uint32 (a jnp
array there is a captured constant that `pallas_call` refuses); its v4
and v5 rows close over (8, 128) arrays the same way, so those rows are
held to r3_exp2.py's `micro`, which passes the weights as an input.

Tolerances: the recurrence bit-equal (NaN-ness for NaN), at R = 64 for
r3_exp1.py's contracting bodies and at OUTER = 2, UNROLL = 4 for
r3_exp2.py's; the `unpack` bodies, whose recurrence is chaotic, over 4
steps.  `sel_kernel` and the tile gathers exact; `warp_budget` at cb = 1
and cb = 3 (1x16x256x3 f32, tile_h = 8) within 1e-5 of `warp_ref`.
"""
import ast
import fractions
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import rife_tpu.ops.pallas.warp as wmod
from rife_tpu.ops import resize_bilinear
from rife_tpu_torch.ops import gather_probe as gp
from rife_tpu_torch.ops.cuda import gather_probe as cuda_gp
from rife_tpu_torch.ops.warp import warp_ref

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
EXP1_NAMES = {"base (3 ops)": "base", "+1 mul": "mul", "+1 lane gather": "lane",
              "+2 lane gathers": "lane2", "+1 sublane gather": "sublane",
              "+unpack only": "unpack", "v4 row (2 gathers+fma)": "v4row",
              "v5 row (1 gather+unpack+fma)": "v5row"}
EXP2_NAMES = {"base": "base", "+1 mul": "mul", "+1 lane gather": "lane",
              "+1 sublane gather": "sublane", "+unpack": "unpack", "v4row": "v4row",
              "v5row": "v5row"}


@functools.lru_cache(maxsize=None)
def _tree(name):
    path = os.path.join(TOOLS, name)
    with open(path) as f:
        return path, ast.parse(f.read())


def _script(name, functions, **consts):
    """The named function definitions of tools/<name>, executed alone in a
    namespace with the imports they use and `consts` -> (namespace, path,
    module tree)."""
    path, tree = _tree(name)
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in functions]
    assert {d.name for d in defs} == set(functions)
    ns = {"jax": jax, "jnp": jnp, "lax": lax, "pl": pl, "pltpu": pltpu, "np": np,
          "functools": functools, "wmod": wmod, **consts}
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"), ns)
    return ns, path, tree


def _expr(node, ns, path):
    return eval(compile(ast.Expression(body=node), path, "eval"), ns)


def _exp1_bodies(ns, path, tree):
    """{body: the lambda (or function) r3_exp1.py passes to `make`}."""
    out = {}
    for stmt in tree.body:
        call = getattr(stmt, "value", None)
        if (isinstance(call, ast.Call) and getattr(call.func, "id", None) == "bench"
                and isinstance(call.args[1], ast.Call)
                and getattr(call.args[1].func, "id", None) == "make"):
            out[EXP1_NAMES[call.args[0].value]] = _expr(call.args[1].args[0], ns, path)
    assert set(out) == set(gp.EXP1_BODIES)
    return out


def _exp2_bodies(ns, path, tree):
    """{body: lambda} from r3_exp2.py's `for name, body in [...]` list."""
    loop = next(s for s in tree.body if isinstance(s, ast.For)
                and isinstance(s.iter, ast.List) and isinstance(s.target, ast.Tuple)
                and [t.id for t in s.target.elts] == ["name", "body"])
    out = {EXP2_NAMES[e.elts[0].value]: _expr(e.elts[1], ns, path) for e in loop.iter.elts}
    assert set(out) == set(gp.EXP2_BODIES)
    return out


def _micro_inputs(seed, idx_hi):
    rng = np.random.default_rng(seed)
    return (rng.random((8, 128), dtype=np.float32),
            rng.integers(0, idx_hi, (8, 128)).astype(np.int32),
            rng.integers(0, 8, (8, 128)).astype(np.int32),
            rng.random((8, 128), dtype=np.float32))


def _same_bits(got, want):
    """Bit-equal, NaN payloads aside."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    return np.array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def _plain_micro(inputs, body, steps, unroll=1):
    return gp.micro(*(torch.from_numpy(a) for a in inputs), body, steps, unroll).numpy()


# r3_exp1.py's v4/v5 rows close over (8, 128) jnp arrays, which
# pallas_call refuses as captured constants: r3_exp2.py holds those rows.
@pytest.mark.parametrize("body", [b for b in gp.EXP1_BODIES if b not in ("v4row", "v5row")])
def test_r3_exp1_make_matches_plain(body):
    """r3_exp1.py's `make` at R = 64 (the `unpack` body at R = 4) against
    `micro` on the CPU: bit-equal."""
    steps = 4 if body in gp.CHAOTIC else 64
    ns, path, tree = _script("r3_exp1.py", {"make", "unpack", "v5_row"}, R=steps,
                             MASK_HI=np.uint32(0xFFFF0000))
    x, idx, idx0, w = inputs = _micro_inputs(1, 128)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ns["make"](_exp1_bodies(ns, path, tree)[body])(x, idx, idx0))
    assert _same_bits(_plain_micro(inputs, body, steps), want)


@pytest.mark.parametrize("body", gp.EXP2_BODIES)
def test_r3_exp2_micro_matches_plain(body):
    """r3_exp2.py's `micro` at OUTER = 2, UNROLL = 4 (the chaotic bodies at
    OUTER = 1: 4 steps) against `micro` on the CPU: bit-equal."""
    outer, unroll = (1, 4) if body in gp.CHAOTIC else (2, 4)
    ns, path, tree = _script("r3_exp2.py", {"micro", "unpack"}, OUTER=outer, UNROLL=unroll)
    inputs = _micro_inputs(2, 127)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ns["micro"](_exp2_bodies(ns, path, tree)[body])(*inputs))
    assert _same_bits(_plain_micro(inputs, body, outer, unroll), want)


def test_r3_exp1_sel_kernel_matches_plain():
    """`sel_kernel` through the script's own `pallas_call` statement (its
    PrefetchScalarGridSpec) on the script's inputs: exact."""
    ns, path, tree = _script("r3_exp1.py", {"sel_kernel"})
    nb, bh, w = 8, 8, 256
    rng = np.random.default_rng(3)
    xsrc = rng.random((nb * bh, w), dtype=np.float32)
    sel = np.array([3, 0, 5, 1], np.int32)
    ns.update(NB=nb, BH=bh, W=w, xsrc=jnp.asarray(xsrc), sel=jnp.asarray(sel))
    stmt = next(s for s in next(t for t in tree.body if isinstance(t, ast.Try)).body
                if isinstance(s, ast.Assign) and s.targets[0].id == "out")
    with pltpu.force_tpu_interpret_mode():
        exec(compile(ast.Module(body=[stmt], type_ignores=[]), path, "exec"), ns)
    got = gp.select_rows(torch.from_numpy(xsrc), torch.from_numpy(sel), bh).numpy()
    assert np.array_equal(got, np.asarray(ns["out"]))


@pytest.mark.parametrize("kind", gp.GATHER_KINDS)
def test_r3_exp21_make_matches_plain(kind):
    """r3_exp21.py's `make` at NT = 4 against `tile_gather` on the CPU, and
    both against numpy's take_along_axis: exact."""
    fn = {"lane": "lane_gather", "sublane": "sublane_gather", "bcast8": "broadcast8"}[kind]
    ns, _, _ = _script("r3_exp21.py", {"make", fn}, S=8, L=128, NT=4)
    rng = np.random.default_rng(4)
    x = rng.random((4, 8, 128), dtype=np.float32)
    idx = rng.integers(0, 128 if kind == "lane" else 8, (4, 8, 128)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ns["make"](kind, ns[fn])(x, idx))
    got = gp.tile_gather(torch.from_numpy(x), torch.from_numpy(idx), kind).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.take_along_axis(x, idx, axis=2 if kind == "lane" else 1))


@pytest.mark.parametrize("cb", [1, 3])
def test_r3_exp1_warp_budget_matches_plain(cb):
    """`warp_budget` (the v3 image warp with the channel block its VMEM
    budget allows) at cb = 1 and cb = 3 on 1x16x256x3 f32, tile_h = 8,
    against `warp_ref` and `warp_nhwc_cb1` on the CPU: within 1e-5."""
    ns, _, _ = _script("r3_exp1.py", {"warp_budget"})
    n, h, w, c = 1, 16, 256, 3
    per_cb = h * w * 4 + 8 * wmod.TILE_W * 4  # a channel's plane + the scratch tile
    rng = np.random.default_rng(5)
    img = rng.random((n, h, w, c), dtype=np.float32)
    coarse = rng.normal(0, 3, (n, h // 4, w // 32, 2)).astype(np.float32)
    flow = np.array(resize_bilinear(jnp.asarray(coarse), (h, w)))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ns["warp_budget"](jnp.asarray(img), jnp.asarray(flow),
                                            cb * per_cb, tile_h=8))
    timg, tflow = torch.from_numpy(img), torch.from_numpy(flow)
    got = gp.warp_nhwc_cb1(timg, tflow).numpy()
    assert np.array_equal(got, warp_ref(timg, tflow).numpy())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_fma_f32_rounds_once():
    """fma_f32 is the one rounding of the exact a * b + c: on a case where
    rounding the f64 sum to f32 rounds twice and lands on the wrong side
    ((0.5 + 2^-24)(1 - 2^-23) + (2^23 + 1) = 2^23 + 1.5 - 2^-47), and on
    seeded random triples against exact rationals."""
    a = torch.tensor([0.5 + 2.0 ** -24])
    b = torch.tensor([1 - 2.0 ** -23])
    c = torch.tensor([2.0 ** 23 + 1])
    assert float((a.double() * b.double() + c.double()).float()) == 2.0 ** 23 + 2
    assert float(gp.fma_f32(a, b, c)) == 2.0 ** 23 + 1
    rng = np.random.default_rng(6)
    v = [rng.normal(0, 1, 4000).astype(np.float32) * np.float32(2.0) ** rng.integers(
        -30, 30, 4000).astype(np.float32) for _ in range(3)]
    got = gp.fma_f32(*(torch.from_numpy(t) for t in v)).numpy()
    exact = [np.float32(float(fractions.Fraction(float(x)) * fractions.Fraction(float(y))
                              + fractions.Fraction(float(z)))) for x, y, z in zip(*v)]
    assert np.array_equal(got, np.array(exact, np.float32))


def test_plain_micro_stops_at_a_fixed_point():
    """Zero input: acc stays 0 from the first step, and any step count
    gives the same answer at once."""
    z = torch.zeros(8, 128)
    i = torch.zeros(8, 128, dtype=torch.int32)
    out = gp.micro_ref(z, i, i, z, "lane2", 10 ** 9, 32)
    assert torch.equal(out, z)


def test_wrappers_refuse_what_they_cannot_take():
    """Shape, dtype and name checks of the wrappers, and the CUDA bindings'
    device checks on CPU tensors (raised before anything is built)."""
    x, idx, idx0, w = (torch.from_numpy(a) for a in _micro_inputs(0, 128))
    with pytest.raises(ValueError):
        gp.micro(x, idx, idx0, w, "gather", 4)
    with pytest.raises(ValueError):
        gp.micro(x, idx, idx0, w, "base", 4, form="lanes")
    with pytest.raises(ValueError):
        gp.micro(x[:4], idx, idx0, w, "base", 4)
    with pytest.raises(ValueError):
        gp.micro(x, idx.long(), idx0, w, "base", 4)
    with pytest.raises(ValueError):
        gp.select_rows(torch.zeros(60, 256), torch.zeros(2, dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        gp.tile_gather(torch.zeros(2, 8, 128), torch.zeros(2, 8, 128, dtype=torch.int32),
                       "row")
    with pytest.raises(ValueError):
        gp.tile_gather(torch.zeros(2, 8, 64), torch.zeros(2, 8, 64, dtype=torch.int32),
                       "lane")
    with pytest.raises(ValueError):
        cuda_gp.launch_micro(x, idx, idx0, w, 0, 4, 1, False, gp.DECAY, gp.MIX, gp.GAIN)
    with pytest.raises(ValueError):
        cuda_gp.launch_select_rows(torch.zeros(64, 256), torch.zeros(4, dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        cuda_gp.launch_tile_gather(torch.zeros(2, 8, 128),
                                   torch.zeros(2, 8, 128, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        cuda_gp.launch_warp_cb1(torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 2))
    assert (gp.micro.launches, gp.select_rows.launches, gp.tile_gather.launches,
            gp.warp_nhwc_cb1.launches) == (0, 0, 0, 0)
