"""The port's serving app on the CPU (`device="cpu"`): the JSON HTTP API
(health, the four endpoints, 404, 403 path confinement of inputs and
outputs, 401/200 basic auth, 503 when degraded) on a free port, each
server shut down after; `build_gradio` under a recording stand-in for
`gradio` (five tabs, degraded mode, every handler run); `load_engine`'s
log line and degraded mode; `main` raising without a card; the
`run_interpolation` CLI and `examples/demo_torch.py` on a temporary
--modelDir."""
import base64
import contextlib
import importlib.util
import io
import json
import sys
import threading
import types
import urllib.error
import urllib.request
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from rife_tpu.models.ifnet import IFNetConfig as JaxIFNetConfig
from rife_tpu_torch.engine.checkpoint import save_params
from rife_tpu_torch.serve import app, config
from rife_tpu_torch.video.mp4meta import read_colr

from test_torch_benchmarks import StandIn
from test_torch_ladder import random_tree
from test_torch_serve import decode, write_clip

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    tree = jax.tree_util.tree_map(np.asarray, random_tree(JaxIFNetConfig(), seed=21,
                                                          flow_gain=4.0))
    save_params(str(d / "flownet.rtpu"), tree, {"model": "rife"})
    return d


@pytest.fixture(scope="module")
def engine(model_dir):
    with contextlib.redirect_stdout(io.StringIO()):
        return app.load_engine(model_dir, device="cpu")


@contextlib.contextmanager
def server(engine, **kw):
    """The API on 127.0.0.1 at a free port, served in a thread; shut down
    and closed on exit."""
    httpd = app.make_http_server(engine, "127.0.0.1", 0, **kw)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(TIMEOUT)
        assert not t.is_alive()


def call(url, body=None, auth=None):
    """(status, JSON body or None)."""
    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 method="GET" if body is None else "POST")
    if auth:
        req.add_header("Authorization", "Basic " + base64.b64encode(auth.encode()).decode())
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        data = e.read()
        return e.code, (json.loads(data) if data else None)


@pytest.fixture
def dirs(tmp_path):
    up, out = tmp_path / "uploads", tmp_path / "outputs"
    up.mkdir()
    out.mkdir()
    rng = np.random.default_rng(0)
    base = rng.random((60, 80, 3))
    for _ in range(3):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) / 3
    cv2.imwrite(str(up / "i0.png"), (base[:40, :56] * 255).astype(np.uint8))
    cv2.imwrite(str(up / "i1.png"), (base[3:43, 4:60] * 255).astype(np.uint8))
    write_clip(up / "a.mp4", 3, 10, seed=1)
    write_clip(up / "b.mp4", 3, 25, seed=2)
    return up, out


def test_health_and_the_four_endpoints(engine, dirs):
    """The serving engine (seeded `rife`, bf16, rung 1) behind the API; the
    chain endpoint, whose transitions take 15 forwards at 512x512, is
    driven with the stand-in engine below."""
    up, out = dirs
    with server(engine, upload_dir=up, output_dir=out) as url:
        assert call(url + "/health") == (200, {"status": "ok", "model": "rife"})
        code, r = call(url + "/interpolate_pair", {
            "img0_path": str(up / "i0.png"), "img1_path": str(up / "i1.png"),
            "passes": 1, "out": str(out / "pair.mp4")})
        assert code == 200 and r == {"frames": 3, "output": str(out / "pair.mp4"),
                                     "disk_based": False}
        assert len(decode(out / "pair.mp4")) == 3 and read_colr(r["output"]) == (1, 1, 1)
        code, r = call(url + "/interpolate_pair", {
            "img0_path": str(up / "i0.png"), "img1_path": str(up / "i1.png"),
            "passes": 1, "disk_based": True})
        assert code == 200 and r["disk_based"] and r["output"] == str(out / "pair.mp4")
        code, r = call(url + "/interpolate_video", {"path": str(up / "a.mp4"), "exp": 1})
        assert code == 200 and (r["frames_in"], r["frames_out"]) == (3, 5)
        assert len(decode(out / "video.mp4")) == 5
        code, r = call(url + "/reencode", {"path": str(up / "b.mp4")})
        assert code == 200 and r["action"] == "reencoded_cv2"
        assert read_colr(str(out / "reencoded.mp4")) == (1, 1, 1)


def test_errors_and_path_confinement(dirs):
    up, out = dirs
    eng = StandIn("torch")
    pair = {"img0_path": str(up / "i0.png"), "img1_path": str(up / "i1.png"), "passes": 1}
    with server(eng, upload_dir=up, output_dir=out) as url:
        assert call(url + "/nope", {})[0] == 404
        assert call(url + "/_in_path", {})[0] == 404
        assert call(url + "/other")[0] == 404
        code, r = call(url + "/interpolate_pair", {**pair, "img0_path": "/etc/hostname"})
        assert code == 403 and "outside upload dir" in r["error"]
        code, r = call(url + "/interpolate_pair", {**pair, "img0_path": str(up / ".." / "x")})
        assert code == 403
        code, r = call(url + "/interpolate_pair", {**pair, "out": str(up / "escape.mp4")})
        assert code == 403 and "outside output dir" in r["error"]
        assert not (up / "escape.mp4").exists()
        assert call(url + "/chain", {"videos": [str(up / "a.mp4"), "/etc/passwd"]})[0] == 403
        code, r = call(url + "/interpolate_pair", {**pair, "img0_path": str(up / "none.png")})
        assert code == 404
        code, r = call(url + "/interpolate_pair", {"passes": 1})
        assert code == 500 and r["error"].startswith("KeyError")
        assert call(url + "/interpolate_pair", pair) == (
            200, {"frames": 3, "output": str(out / "pair.mp4"), "disk_based": False})
        # The chain's transitions at the default 4 passes: 15 forwards a gap.
        code, r = call(url + "/chain", {"videos": [str(up / "a.mp4"), str(up / "b.mp4")]})
        assert code == 200 and r["mode"] == "cv2" and r["frames"] == 3 + 15 + 3
        assert len(decode(out / "chained.mp4")) == 21


def test_basic_auth(dirs):
    up, out = dirs
    with server(StandIn("torch"), upload_dir=up, output_dir=out,
                auth=("admin", "secret")) as url:
        assert call(url + "/health") == (401, None)
        assert call(url + "/health", auth="admin:wrong") == (401, None)
        assert call(url + "/reencode", {"path": str(up / "a.mp4")})[0] == 401
        assert call(url + "/health", auth="admin:secret")[0] == 200


def test_auth_from_the_environment(dirs, monkeypatch):
    up, out = dirs
    monkeypatch.setattr(config, "AUTH_USERNAME", "u")
    monkeypatch.setattr(config, "AUTH_PASSWORD", "p")
    with server(StandIn("torch"), upload_dir=up, output_dir=out) as url:
        assert call(url + "/health")[0] == 401
        assert call(url + "/health", auth="u:p")[0] == 200


def test_degraded_mode(dirs, tmp_path, capsys):
    up, out = dirs
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "flownet.rtpu").write_bytes(b"not a checkpoint")
    assert app.load_engine(bad, device="cpu") is None
    assert "Traceback" in capsys.readouterr().err
    with server(None, upload_dir=up, output_dir=out) as url:
        assert call(url + "/health") == (200, {"status": "degraded", "model": None})
        code, r = call(url + "/interpolate_pair", {"img0_path": str(up / "i0.png")})
        assert code == 503 and "degraded" in r["error"]
        assert call(url + "/reencode", {"path": str(up / "a.mp4")})[0] == 200


def test_load_engine_logs_its_graph(model_dir, capsys, monkeypatch):
    monkeypatch.setattr(config, "FAST_MODE", 0)
    eng = app.load_engine(model_dir, device="cpu")
    line = capsys.readouterr().out
    assert eng.compute_dtype == torch.bfloat16 and eng.model_name == "rife"
    assert "serving graph: bit-exact (RIFE_TPU_TORCH_FAST=" in line
    assert f"checkpoint={model_dir / 'flownet.rtpu'}" in line and "device=cpu" in line
    assert eng.model_def.config.fast_level0 is False
    monkeypatch.setattr(config, "FAST_MODE", 1)
    eng = app.load_engine(model_dir, device="cpu")
    assert "fast rung 1" in capsys.readouterr().out and eng.model_def.config.fast_level0


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, args in ((app.main, ["--http"]),
                       (_run_interpolation().main, ["a.png", "b.png", "o.mp4"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args)


def test_main_serves_http_without_gradio(model_dir, monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(config, "TEMP_DIR", tmp_path / "temp")
    monkeypatch.setattr(config, "UPLOAD_DIR", tmp_path / "temp" / "uploads")
    monkeypatch.setattr(config, "OUTPUT_DIR", tmp_path / "temp" / "outputs")
    monkeypatch.setattr(config, "FRAMES_DIR", tmp_path / "temp" / "frames")
    monkeypatch.setitem(sys.modules, "gradio", None)  # not installed
    monkeypatch.setattr(app, "serve_http", lambda eng, host, port: seen.update(
        eng=eng, host=host, port=port))
    with contextlib.redirect_stdout(io.StringIO()) as out:
        app.main(["--device", "cpu", "--modelDir", str(model_dir), "--port", "0",
                  "--host", "127.0.0.1", "--no-warmup"])
    assert "falling back to the JSON HTTP API" in out.getvalue()
    assert seen["eng"].model_name == "rife" and (seen["host"], seen["port"]) == ("127.0.0.1", 0)
    assert (tmp_path / "temp" / "uploads").is_dir()


# ---------------------------------------------------------------- Gradio


class _Component:
    def __init__(self, state, kind, *args, **kwargs):
        self.state, self.kind, self.args, self.kwargs = state, kind, args, kwargs

    def __enter__(self):
        if self.kind == "Tab":
            self.state["tabs"].append(self)
        return self

    def __exit__(self, *exc):
        return False

    def click(self, fn, inputs, outputs):
        self.state["handlers"].append({"fn": fn, "inputs": inputs, "outputs": outputs,
                                       "btn": self, "tab": self.state["tabs"][-1]})


@pytest.fixture
def fake_gradio(monkeypatch):
    state = {"tabs": [], "handlers": []}
    mod = types.ModuleType("gradio")
    for kind in ("Blocks", "Tab", "Markdown", "Video", "Image", "Number", "Slider",
                 "Checkbox", "Button", "Textbox"):
        setattr(mod, kind, (lambda k: lambda *a, **kw: _Component(state, k, *a, **kw))(kind))
    monkeypatch.setitem(sys.modules, "gradio", mod)
    return state


TABS = ["Frame extraction", "Image pair → video", "Chained transitions",
        "Video interpolation", "Re-encode"]


def test_gradio_has_the_five_tabs(fake_gradio):
    demo = app.build_gradio(StandIn("torch"))
    assert demo.kind == "Blocks"
    assert [t.args[0] for t in fake_gradio["tabs"]] == TABS
    assert len(fake_gradio["handlers"]) == 5
    assert all(callable(h["fn"]) and h["inputs"] and h["outputs"]
               for h in fake_gradio["handlers"])


def test_gradio_degraded_mode(fake_gradio):
    app.build_gradio(None)
    by_tab = {h["tab"].args[0]: h["btn"] for h in fake_gradio["handlers"]}
    for tab in TABS[1:4]:
        assert by_tab[tab].kwargs.get("interactive") is False, tab
    for tab in (TABS[0], TABS[4]):
        assert by_tab[tab].kwargs.get("interactive") is not False, tab


def test_gradio_handlers_run(fake_gradio, tmp_path, monkeypatch, dirs):
    up, _ = dirs
    monkeypatch.setattr(config, "OUTPUT_DIR", tmp_path)
    monkeypatch.setattr(config, "FRAMES_DIR", tmp_path / "frames")
    app.build_gradio(StandIn("torch"))
    h = {rec["tab"].args[0]: rec["fn"] for rec in fake_gradio["handlers"]}
    vid = str(up / "a.mp4")
    assert h["Frame extraction"](vid, 2) == f"extracted 2 frames to {tmp_path / 'frames'}"
    i0 = cv2.imread(str(up / "i0.png"))[..., ::-1]
    out, info = h["Image pair → video"](i0, i0, 1, 10, False)
    assert out == str(tmp_path / "pair.mp4") and json.loads(info)["frames"] == 3
    out, info = h["Video interpolation"](vid, 1)
    assert json.loads(info)["frames_out"] == 5
    out, info = h["Chained transitions"](vid, str(up / "b.mp4"), None)
    assert json.loads(info)["frames"] == 3 + 15 + 3
    out, info = h["Re-encode"](vid)
    assert json.loads(info)["action"] == "reencoded_cv2"


# ---------------------------------------------------------------- CLIs


def _run_interpolation():
    from rife_tpu_torch.cli import run_interpolation

    return run_interpolation


def test_run_interpolation_cli(model_dir, dirs, tmp_path, capsys):
    up, _ = dirs
    out = tmp_path / "o.mp4"
    _run_interpolation().main([str(up / "i0.png"), str(up / "i1.png"), str(out),
                               "--passes", "1", "--modelDir", str(model_dir),
                               "--device", "cpu", "--disk-based"])
    printed = capsys.readouterr().out
    assert "{'frames': 3, 'output': '%s', 'disk_based': True}" % out in printed
    assert len(decode(out)) == 3


def test_demo_torch(model_dir, dirs, tmp_path, capsys):
    up, _ = dirs
    spec = importlib.util.spec_from_file_location("demo_torch",
                                                  ROOT / "examples" / "demo_torch.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    demo.main([str(up / "i0.png"), str(up / "i1.png"), "--out", str(tmp_path / "d"),
               "--modelDir", str(model_dir), "--device", "cpu"])
    assert "slomo.mp4" in capsys.readouterr().out
    assert cv2.imread(str(tmp_path / "d" / "strip.png")).shape == (40, 3 * 56, 3)
    assert len(decode(tmp_path / "d" / "slomo.mp4")) == 9
    assert read_colr(str(tmp_path / "d" / "slomo.mp4")) == (1, 1, 1)
