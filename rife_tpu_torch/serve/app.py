"""Serving app (port of rife_tpu/serve/app.py; reference
rife_app/app.py:21-460).

    python -m rife_tpu_torch.serve.app [--http] [--port 7860] [--modelDir DIR]
                                       [--device cuda|cpu]

Two frontends over the same service layer:

- Gradio Blocks UI with the reference's five tabs (frame extraction,
  image pair -> video, chained transitions, video interpolation,
  re-encoding), degraded mode when the model fails to load, optional
  basic auth via AUTH_USERNAME/AUTH_PASSWORD (app.py:26-30,442-451) —
  used when gradio is importable.
- A stdlib http.server JSON API (used with --http or without gradio):
      GET  /health
      POST /interpolate_pair   {img0_path, img1_path, passes, fps, out, disk_based}
      POST /interpolate_video  {path, exp, out}
      POST /chain              {videos: [...], out, transition_passes}
      POST /reencode           {path, out}

The engine runs on the card unless `--device cpu` is given; `main`
raises without a card.
"""
from __future__ import annotations

import base64
import hmac
import json
import os
import traceback
from pathlib import Path

import numpy as np

from rife_tpu_torch.serve import config
from rife_tpu_torch.serve import services


def load_engine(model_dir=None, device=None):
    """The serving engine (bf16, rung `config.FAST_MODE`) of `model_dir`'s
    checkpoint (its `flownet.rtpu`, then `flownet.pkl`; seeded initial
    weights where there is none); None on failure (degraded mode,
    reference app.py:26-30)."""
    from rife_tpu_torch.engine import build_engine, find_checkpoint

    try:
        model_dir = str(model_dir or config.MODEL_DIR)
        ckpt = find_checkpoint(model_dir)
        eng = build_engine(ckpt, None, 1.0, "bfloat16", fast=config.FAST_MODE,
                           device=device)
        # Deployments must be able to see which graph they serve: the
        # fast rung is an env-controlled default.
        print(f"[rife_tpu_torch] serving graph: "
              f"{'bit-exact' if not config.FAST_MODE else f'fast rung {int(config.FAST_MODE)}'}"
              f" ({config.FAST_ENV}={os.environ.get(config.FAST_ENV, '<unset, default 1>')}),"
              f" model={eng.model_name}, dtype={eng.compute_dtype}, device={eng.device},"
              f" checkpoint={ckpt or '<none: seeded initial weights>'}", flush=True)
        return eng
    except Exception:
        traceback.print_exc()
        return None


# ---------------------------------------------------------------- HTTP API


class _Api:
    """JSON API over the service layer.

    Request-supplied filesystem paths are CONFINED: inputs must resolve
    under `upload_dir`, outputs under `output_dir` — a network peer must
    not be able to read or overwrite arbitrary files the process can
    reach.
    """

    def __init__(self, engine, upload_dir=None, output_dir=None):
        self.engine = engine
        self.upload_dir = Path(upload_dir or config.UPLOAD_DIR).resolve()
        self.output_dir = Path(output_dir or config.OUTPUT_DIR).resolve()

    def _in_path(self, p) -> str:
        q = Path(p).resolve()
        if not q.is_relative_to(self.upload_dir):
            raise PermissionError(f"input path outside upload dir: {p}")
        return str(q)

    def _out_path(self, p, default_name: str) -> str:
        if not p:
            return str(self.output_dir / default_name)
        q = Path(p).resolve()
        if not q.is_relative_to(self.output_dir):
            raise PermissionError(f"output path outside output dir: {p}")
        return str(q)

    def health(self, _=None):
        return {"status": "ok" if self.engine else "degraded",
                "model": getattr(self.engine, "model_name", None)}

    def interpolate_pair(self, body):
        from rife_tpu_torch.utils.imageio import read_image

        img0, _ = read_image(self._in_path(body["img0_path"]))
        img1, _ = read_image(self._in_path(body["img1_path"]))
        out = self._out_path(body.get("out"), "pair.mp4")
        return services.interpolate_pair_to_video(
            self.engine, img0, img1, out,
            passes=int(body.get("passes", 4)), fps=float(body.get("fps", config.DEFAULT_FPS)),
            disk_based=bool(body.get("disk_based", False)),
        )

    def interpolate_video(self, body):
        out = self._out_path(body.get("out"), "video.mp4")
        return services.interpolate_video_file(
            self.engine, self._in_path(body["path"]), out, exp=int(body.get("exp", 1))
        )

    def chain(self, body):
        out = self._out_path(body.get("out"), "chained.mp4")
        videos = [self._in_path(v) for v in body["videos"]]
        return services.chained_transitions(
            self.engine, videos, out,
            transition_passes=int(body.get("transition_passes", 4)))

    def reencode(self, body):
        out = self._out_path(body.get("out"), "reencoded.mp4")
        return services.reencode_video(self._in_path(body["path"]), out)


def make_http_server(engine, host: str, port: int, *, upload_dir=None,
                     output_dir=None, auth=None):
    """The stdlib JSON API's server, bound and not yet serving (port 0
    binds a free port: `server.server_address[1]`).  `auth` is (user,
    password) — defaults to the AUTH_USERNAME/AUTH_PASSWORD env pair
    (the contract the reference wires into gradio, app.py:442-451); when
    set, every request must carry HTTP basic auth."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    if auth is None and config.AUTH_USERNAME and config.AUTH_PASSWORD:
        auth = (config.AUTH_USERNAME, config.AUTH_PASSWORD)
    expected = None
    if auth:
        expected = "Basic " + base64.b64encode(
            f"{auth[0]}:{auth[1]}".encode()).decode()

    api = _Api(engine, upload_dir=upload_dir, output_dir=output_dir)

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, obj):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _authed(self) -> bool:
            if expected is None:
                return True
            got = self.headers.get("Authorization", "")
            if hmac.compare_digest(got, expected):
                return True
            self.send_response(401)
            self.send_header("WWW-Authenticate", 'Basic realm="rife_tpu_torch"')
            self.send_header("Content-Length", "0")
            self.end_headers()
            return False

        def do_GET(self):
            if not self._authed():
                return
            if self.path == "/health":
                self._send(200, api.health())
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if not self._authed():
                return
            name = self.path.strip("/")
            fn = getattr(api, name, None)
            if fn is None or name.startswith("_") or not callable(fn):
                self._send(404, {"error": f"unknown endpoint {self.path}"})
                return
            if api.engine is None and name != "reencode":
                self._send(503, {"error": "degraded: model not loaded"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
                self._send(200, fn(body))
            except PermissionError as e:
                self._send(403, {"error": str(e)})
            except FileNotFoundError as e:
                self._send(404, {"error": str(e)})
            except Exception as e:
                traceback.print_exc()
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *a):
            pass

    return ThreadingHTTPServer((host, port), Handler)


def serve_http(engine, host: str, port: int, *, upload_dir=None,
               output_dir=None, auth=None):
    """Serve the JSON API until the process ends (`make_http_server`)."""
    httpd = make_http_server(engine, host, port, upload_dir=upload_dir,
                             output_dir=output_dir, auth=auth)
    print(f"rife_tpu_torch HTTP API on {host}:{httpd.server_address[1]} "
          f"({'ready' if engine else 'DEGRADED - no model'})", flush=True)
    httpd.serve_forever()


# ---------------------------------------------------------------- Gradio UI


def build_gradio(engine):
    import gradio as gr

    degraded = engine is None

    def _pair(img0, img1, passes, fps, disk):
        out = str(config.OUTPUT_DIR / "pair.mp4")
        r = services.interpolate_pair_to_video(
            engine, np.asarray(img0, np.float32) / 255.0,
            np.asarray(img1, np.float32) / 255.0, out,
            passes=int(passes), fps=float(fps), disk_based=bool(disk))
        return out, json.dumps(r)

    def _video(path, exp):
        out = str(config.OUTPUT_DIR / "video.mp4")
        r = services.interpolate_video_file(engine, path, out, exp=int(exp))
        return out, json.dumps(r)

    def _chain(v1, v2, v3):
        out = str(config.OUTPUT_DIR / "chained.mp4")
        vids = [v for v in (v1, v2, v3) if v]
        r = services.chained_transitions(engine, vids, out)
        return out, json.dumps(r)

    def _extract(path, limit):
        from rife_tpu_torch.video.framing import extract_frames

        d = str(config.FRAMES_DIR)
        n = extract_frames(path, d, int(limit) if limit else None)
        return f"extracted {n} frames to {d}"

    def _reencode(path):
        out = str(config.OUTPUT_DIR / "reencoded.mp4")
        r = services.reencode_video(path, out)
        return out, json.dumps(r)

    with gr.Blocks(title="RIFE (PyTorch/CUDA)") as demo:
        gr.Markdown("# RIFE video frame interpolation (PyTorch/CUDA)"
                    + (" — **DEGRADED: model not loaded**" if degraded else ""))
        with gr.Tab("Frame extraction"):
            v = gr.Video()
            lim = gr.Number(label="limit", value=0)
            btn = gr.Button("Extract")
            out = gr.Textbox()
            btn.click(_extract, [v, lim], out)
        with gr.Tab("Image pair → video"):
            i0, i1 = gr.Image(), gr.Image()
            passes = gr.Slider(1, 8, value=4, step=1, label="2^n passes")
            fps = gr.Number(value=config.DEFAULT_FPS, label="fps")
            disk = gr.Checkbox(label="disk-based (O(1) memory)")
            btn2 = gr.Button("Interpolate", interactive=not degraded)
            vid, info = gr.Video(), gr.Textbox()
            btn2.click(_pair, [i0, i1, passes, fps, disk], [vid, info])
        with gr.Tab("Chained transitions"):
            v1, v2, v3 = gr.Video(), gr.Video(), gr.Video()
            btn3 = gr.Button("Chain", interactive=not degraded)
            vid3, info3 = gr.Video(), gr.Textbox()
            btn3.click(_chain, [v1, v2, v3], [vid3, info3])
        with gr.Tab("Video interpolation"):
            v4 = gr.Video()
            exp = gr.Slider(1, 4, value=1, step=1, label="exp (2^n X)")
            btn4 = gr.Button("Interpolate", interactive=not degraded)
            vid4, info4 = gr.Video(), gr.Textbox()
            btn4.click(_video, [v4, exp], [vid4, info4])
        with gr.Tab("Re-encode"):
            v5 = gr.Video()
            btn5 = gr.Button("Re-encode")
            vid5, info5 = gr.Video(), gr.Textbox()
            btn5.click(_reencode, [v5], [vid5, info5])
    return demo


def main(argv=None):
    import argparse

    from rife_tpu_torch.engine import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default=config.SERVER_NAME)
    ap.add_argument("--port", type=int, default=config.SERVER_PORT)
    ap.add_argument("--modelDir", default=None)
    ap.add_argument("--http", action="store_true", help="force the JSON API frontend")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the startup request at the common shape bucket")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)  # raises without a card
    config.ensure_dirs()
    engine = load_engine(args.modelDir, device=device)

    if engine is not None and not args.no_warmup:
        # One request at the service layer's most common bucket (the
        # centred min-512 %32 pad contract), so cuDNN has chosen its
        # kernels before the first user's request.
        try:
            engine.warmup((1, 512, 512, 3))
        except Exception:
            traceback.print_exc()

    if not args.http:
        try:
            demo = build_gradio(engine)
            auth = None
            if config.AUTH_USERNAME and config.AUTH_PASSWORD:
                auth = (config.AUTH_USERNAME, config.AUTH_PASSWORD)
            demo.launch(server_name=args.host, server_port=args.port, auth=auth)
            return
        except ImportError:
            print("gradio not installed; falling back to the JSON HTTP API")
    serve_http(engine, args.host, args.port)


if __name__ == "__main__":
    main()
