"""The reference's own PyTorch checkpoints in the port: `flownet.pkl`
loading (`load_checkpoint`'s pickle branch, `import_ifnet`,
`import_v425`), the export back (`models.torch_export`) and the `convert`
CLI, against rife_tpu's loader, exporter and converter on the CPU."""
import os

import jax
import numpy as np
import pytest
import torch

from rife_tpu.cli import convert as ref_convert
from rife_tpu.engine.checkpoint import load_checkpoint as ref_load
from rife_tpu.models import registry as ref_registry
from rife_tpu.models import torch_export as ref_export
from rife_tpu.models.ifnet import IFNetConfig as JaxIFNetConfig
from rife_tpu_torch.cli import convert
from rife_tpu_torch.engine import InferenceEngine, load_checkpoint, state_dict_from_jax
from rife_tpu_torch.engine.checkpoint import jax_tree_from_state_dict, save_params
from rife_tpu_torch.models import detect_model_from_state_dict
from rife_tpu_torch.models import torch_export

from test_torch_ladder import pair, random_tree

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT_V425 = os.path.join(ROOT, "train_log_r5_v425", "flownet.rtpu")


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def assert_trees_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert [jax.tree_util.keystr(p) for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def trees():
    """Seeded trees of the paper family: `rife` with the teacher and the
    refine stage, `rife_m`, and `rife` without the refine stage."""
    return {"rife": random_tree(JaxIFNetConfig(), seed=31),
            "rife_m": random_tree(JaxIFNetConfig(variant="rife_m"), seed=32),
            "no_refine": random_tree(JaxIFNetConfig(refine=False), seed=33)}


@pytest.mark.parametrize("kind", ["rife", "rife_m", "no_refine"])
def test_reference_pickle_loads_to_equal_trees(tmp_path, trees, kind):
    path = str(tmp_path / "flownet.pkl")
    ref_export.save_torch_pickle(path, ref_export.export_ifnet(trees[kind]))
    name, tree = load_checkpoint(path)
    ref_name, ref_tree = ref_load(path)
    assert name == ref_name == ("rife_m" if kind == "rife_m" else "rife")
    assert_trees_equal(tree, ref_tree)
    assert_trees_equal(tree, trees[kind])
    assert ("unet" in tree) == (kind != "no_refine")


def test_ddp_prefixes_are_stripped(tmp_path, trees):
    sd = ref_export.export_ifnet(trees["rife"])
    path = str(tmp_path / "ddp.pkl")
    torch.save({f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}, path)
    assert_trees_equal(load_checkpoint(path)[1], ref_load(path)[1])


def test_model_override_loads_rife_2r(tmp_path, trees):
    path = str(tmp_path / "flownet.pkl")
    ref_export.save_torch_pickle(path, ref_export.export_ifnet(trees["rife"]))
    name, tree = load_checkpoint(path, model="rife_2r")
    assert name == ref_load(path, model="rife_2r")[0] == "rife_2r"
    sd = state_dict_from_jax(tree, model="rife_2r")
    eng = InferenceEngine("rife_2r", sd, device="cpu")
    a, b = pair(32, 64, seed=1)
    assert eng.interpolate(a[:1], b[:1]).shape == (1, 32, 64, 3)


@pytest.mark.parametrize("kind", ["rife", "rife_m", "no_refine"])
def test_port_pickle_loads_in_rife_tpu(tmp_path, trees, kind):
    path = str(tmp_path / "flownet.pkl")
    sd = torch_export.export_ifnet(trees[kind])
    want = ref_export.export_ifnet(trees[kind])
    assert sorted(sd) == sorted(want)
    for k in sd:
        np.testing.assert_array_equal(sd[k], want[k], err_msg=k)
    torch_export.save_torch_pickle(path, sd)
    assert_trees_equal(ref_load(path)[1], trees[kind])


def test_export_from_a_state_dict_of_the_port(tmp_path):
    """A port state dict -> the reference tree -> a pickle the reference
    reads back to the same weights."""
    sd = state_dict_from_jax(random_tree(JaxIFNetConfig(), seed=34))
    path = str(tmp_path / "flownet.pkl")
    torch_export.save_torch_pickle(path, torch_export.export_ifnet(
        jax_tree_from_state_dict(sd)))
    back = state_dict_from_jax(ref_load(path)[1])
    assert sorted(back) == sorted(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)


def _v425_reference_dict(tree) -> dict:
    """The in-repo v4.25 tree under the reference's PyTorch names and
    layouts (train_log/IFNet_HDv3.py), with the teacher/caltime keys the
    loader ignores."""
    conv = lambda w: np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))  # noqa: E731
    deconv = lambda w: np.ascontiguousarray(  # noqa: E731
        np.flip(np.asarray(w).transpose(2, 3, 0, 1), (2, 3)))
    sd = {}
    for i in range(5):
        blk, pre = tree[f"block{i}"], f"block{i}"
        for j in range(2):
            sd[f"{pre}.conv0.{j}.0.weight"] = conv(blk["conv0"][j]["w"])
            sd[f"{pre}.conv0.{j}.0.bias"] = np.asarray(blk["conv0"][j]["b"])
        for k in range(8):
            cb = blk["convblock"][k]
            sd[f"{pre}.convblock.{k}.conv.weight"] = conv(cb["conv"]["w"])
            sd[f"{pre}.convblock.{k}.conv.bias"] = np.asarray(cb["conv"]["b"])
            sd[f"{pre}.convblock.{k}.beta"] = np.asarray(cb["beta"]).reshape(1, -1, 1, 1)
        sd[f"{pre}.lastconv.0.weight"] = deconv(blk["lastconv"]["w"])
        sd[f"{pre}.lastconv.0.bias"] = np.asarray(blk["lastconv"]["b"])
    for name in ("cnn0", "cnn1", "cnn2", "cnn3"):
        w = tree["encode"][name]["w"]
        sd[f"encode.{name}.weight"] = deconv(w) if name == "cnn3" else conv(w)
        sd[f"encode.{name}.bias"] = np.asarray(tree["encode"][name]["b"])
    sd["teacher.conv0.0.0.weight"] = np.zeros((4, 3, 3, 3), np.float32)
    sd["caltime.0.weight"] = np.zeros((2, 2, 1, 1), np.float32)
    return sd


def test_v425_from_a_reference_named_dict(tmp_path):
    _, tree = load_checkpoint(CKPT_V425)
    path = str(tmp_path / "flownet.pkl")
    torch.save({k: torch.from_numpy(v) for k, v in _v425_reference_dict(tree).items()},
               path)
    name, got = load_checkpoint(path)
    ref_name, ref_tree = ref_load(path)
    assert name == ref_name == "v4.25"
    assert_trees_equal(got, ref_tree)
    assert_trees_equal(got, tree)
    a, b = pair(64, 128, seed=2)
    outs = [InferenceEngine("v4.25", state_dict_from_jax(t, model="v4.25"), fast=1,
                            device="cpu").interpolate(a[:1], b[:1], 0.25) for t in (got, tree)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_legacy_single_pickle_is_refused(tmp_path):
    path = str(tmp_path / "flownet.pkl")
    torch.save({"block0.conv1.weight": torch.zeros(4, 4, 4, 4),
                "block0.conv0.0.0.weight": torch.zeros(4, 6, 3, 3)}, path)
    with pytest.raises(ValueError, match="trio"):
        load_checkpoint(path)


def _key_dicts(trees):
    paper = ref_export.export_ifnet(trees["rife"])
    paper_m = ref_export.export_ifnet(trees["rife_m"])
    _, v425 = load_checkpoint(CKPT_V425)
    return {
        "rife": paper, "rife_m": paper_m, "v4.25": _v425_reference_dict(v425),
        "ddp rife_m": {f"module.{k}": v for k, v in paper_m.items()},
        "hdv2 flownet": {"block0.conv1.weight": np.zeros((4, 4, 4, 4), np.float32),
                         "block0.conv0.0.0.weight": np.zeros((4, 6, 3, 3), np.float32)},
        "hdv2 trio": {"flownet.block0.conv1.weight": np.zeros(1, np.float32)},
        "hd trio": {"flownet.block0.res0.conv1.0.weight": np.zeros(1, np.float32)},
        "keys only": [k for k in paper if k.startswith("block")],
    }


def test_detection_agrees_with_reference(trees):
    for label, sd in _key_dicts(trees).items():
        want = ref_registry.detect_model_from_state_dict(sd)
        assert detect_model_from_state_dict(sd) == want, label
    with pytest.raises(ValueError):
        detect_model_from_state_dict({"nothing.weight": np.zeros(1)})
    with pytest.raises(ValueError):
        ref_registry.detect_model_from_state_dict({"nothing.weight": np.zeros(1)})


def test_convert_round_trips(tmp_path, trees):
    rtpu = str(tmp_path / "in.rtpu")
    save_params(rtpu, trees["rife_m"], meta={"model": "rife_m"})
    pkl, back = str(tmp_path / "out.pkl"), str(tmp_path / "back.rtpu")
    convert.main(["--input", rtpu, "--output", pkl, "--to", "torch"])
    convert.main(["--input", pkl, "--output", back])
    name, tree = load_checkpoint(back)
    assert name == "rife_m"
    assert_trees_equal(tree, trees["rife_m"])
    # rife_tpu's converter writes the same pickle and reads the port's back
    ref_pkl, ref_back = str(tmp_path / "ref.pkl"), str(tmp_path / "ref_back.rtpu")
    ref_convert.main(["--input", rtpu, "--output", ref_pkl, "--to", "torch"])
    a, b = torch.load(pkl, weights_only=True), torch.load(ref_pkl, weights_only=True)
    assert sorted(a) == sorted(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    ref_convert.main(["--input", pkl, "--output", ref_back])
    assert_trees_equal(load_checkpoint(ref_back)[1], tree)


def test_convert_refuses_torch_export_outside_the_paper_family(tmp_path):
    with pytest.raises(SystemExit, match="paper family"):
        convert.main(["--input", CKPT_V425, "--output", str(tmp_path / "x.pkl"),
                      "--to", "torch"])
    assert not os.path.exists(tmp_path / "x.pkl")
