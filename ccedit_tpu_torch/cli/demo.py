"""Web demo (port of ``ccedit_tpu/cli/demo.py``): a standard-library
``http.server`` form in front of ``cli/sampling_image.py``'s session and
``sample_images``, the code path of the headless CLI.

    python -m ccedit_tpu_torch.cli.demo --config_path sd21_768 --bf16 [--port 7860]
        [--version "sd21=configs/sd_2_1.yaml:ckpts/v2-1.safetensors"] ...

GET / serves the form (model version, prompts, seed, size, steps, CFG,
samples, img2img strength, sampler, discretization, guider, an init image);
POST /generate takes it url-encoded or as multipart/form-data (an uploaded
init image must be a PNG) and answers with the form and the samples as
base64 PNGs (the port's own encoder, ``data/video.py::png_bytes``); GET
/health answers ``{"status": "ok"}``.  Models stay warm across requests
in a bounded cache of sessions (``SESSION_CACHE`` model versions, least
recently used out first); requests are served one at a time.
"""

from __future__ import annotations

import argparse
import base64
import html
import json
import os
import tempfile
import time
from email.message import Message
from email.parser import BytesParser
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs

from ..config import SAMPLER_NAMES
from ..data.video import png_bytes
from .sampling_image import (DISCRETIZATION_NAMES, GUIDER_NAMES, LRU, ImageSession,
                             add_image_args, build_image_session, sample_images)

SESSION_CACHE = 2  # model versions kept warm

_FORM_FIELDS = (
    ("prompt", "a professional photograph", "text"),
    ("negative_prompt", "", "text"),
    ("seed", "42", "number"),
    ("H", "512", "number"),
    ("W", "512", "number"),
    ("sample_steps", "40", "number"),
    ("cfg_scale", "7.5", "number"),
    ("num_samples", "1", "number"),
    ("img2img_strength", "0.75", "number"),
)


def parse_multipart(body: bytes, content_type: str) -> Tuple[Dict[str, str], Dict[str, bytes]]:
    """A multipart/form-data body's fields and (non-empty) files, parsed
    with the standard library's email machinery."""
    head = f"Content-Type: {content_type}\r\nMIME-Version: 1.0\r\n\r\n".encode()
    msg: Message = BytesParser().parsebytes(head + body)
    fields: Dict[str, str] = {}
    files: Dict[str, bytes] = {}
    for part in msg.get_payload():
        name = part.get_param("name", header="content-disposition")
        if name is None:
            continue
        payload = part.get_payload(decode=True) or b""
        if part.get_filename():
            if payload:
                files[name] = payload
        else:
            fields[name] = payload.decode("utf-8", "replace")
    return fields, files


class DemoState:
    """The base arguments, the model versions and the warm sessions, one
    per version (the port's engine does not depend on the image size)."""

    def __init__(self, base_args, versions: Dict[str, Dict[str, str]],
                 cache_size: int = SESSION_CACHE):
        self.base_args = base_args
        self.versions = versions
        self.sessions = LRU(cache_size)

    def version(self, fields: Dict[str, str]) -> str:
        return fields.get("version", next(iter(self.versions)))

    def request_args(self, fields: Dict[str, str],
                     init_image_path: str = "") -> argparse.Namespace:
        args = argparse.Namespace(**vars(self.base_args))
        spec = self.versions[self.version(fields)]
        args.config_path = spec["config"]
        if spec.get("ckpt"):
            args.ckpt_path = spec["ckpt"]
        for key, default, _ in _FORM_FIELDS:
            raw = fields.get(key, default)
            cur = getattr(args, key)
            setattr(args, key, raw if isinstance(cur, str) else type(cur)(raw))
        args.sampler_name = fields.get("sampler_name", args.sampler_name)
        args.discretization = fields.get("discretization", args.discretization)
        args.guider = fields.get("guider", args.guider)
        args.init_image = init_image_path
        return args

    def session(self, fields: Dict[str, str], args) -> ImageSession:
        return self.sessions.get_or_make(self.version(fields),
                                         lambda: build_image_session(args))


def render_form(state: DemoState, message: str = "", images_b64: Optional[list] = None) -> str:
    def opt(names, sel=None):
        return "".join(f'<option{" selected" if n == sel else ""}>{html.escape(str(n))}</option>'
                       for n in names)

    rows = "".join(f'<tr><td>{k}</td><td><input name="{k}" value="{v}" type="{t}" '
                   f'step="any"></td></tr>' for k, v, t in _FORM_FIELDS)
    imgs = "".join(f'<img src="data:image/png;base64,{b}" style="max-width:512px;margin:4px">'
                   for b in (images_b64 or []))
    a = state.base_args
    return f"""<!doctype html><html><head><title>ccedit demo</title></head>
<body style="font-family:sans-serif;max-width:720px;margin:2em auto">
<h2>ccedit sampling demo</h2>
<p>{html.escape(message)}</p>
<form method="post" action="/generate" enctype="multipart/form-data">
<table>
<tr><td>version</td><td><select name="version">{opt(state.versions)}</select></td></tr>
{rows}
<tr><td>sampler</td><td><select name="sampler_name">{opt(sorted(SAMPLER_NAMES), a.sampler_name)}</select></td></tr>
<tr><td>discretization</td><td><select name="discretization">{opt(DISCRETIZATION_NAMES, a.discretization)}</select></td></tr>
<tr><td>guider</td><td><select name="guider">{opt(GUIDER_NAMES, a.guider)}</select></td></tr>
<tr><td>init image (img2img, PNG)</td><td><input type="file" name="init_image"></td></tr>
</table>
<button type="submit">Generate</button>
</form>
<div>{imgs}</div>
</body></html>"""


def _png_b64(arr) -> str:
    return base64.b64encode(png_bytes(arr)).decode()


def make_handler(state: DemoState):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: str, ctype="text/html; charset=utf-8"):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, fmt, *a):  # one line a request is printed below
            pass

        def do_GET(self):
            if self.path == "/health":
                self._send(200, json.dumps({"status": "ok"}), "application/json")
            else:
                self._send(200, render_form(state))

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, "not found")
                return
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            ctype = self.headers.get("Content-Type", "")
            if ctype.startswith("multipart/form-data"):
                fields, files = parse_multipart(body, ctype)
            else:
                fields, files = {k: v[0] for k, v in parse_qs(body.decode()).items()}, {}
            init_path = ""
            if files.get("init_image"):
                with tempfile.NamedTemporaryFile(suffix=".png", delete=False) as f:
                    f.write(files["init_image"])
                init_path = f.name
            try:
                args = state.request_args(fields, init_path)
                t0 = time.time()
                session = state.session(fields, args)
                save_dir = Path(args.save_path) / time.strftime("%Y%m%d_%H%M%S")
                outs = sample_images(session, args, save_dir=save_dir)
                dt = time.time() - t0
                print(f"[demo] {args.sampler_name} {args.sample_steps} steps {args.H}x{args.W} "
                      f"x{args.num_samples}: {dt:.1f}s -> {save_dir}", flush=True)
                self._send(200, render_form(
                    state, message=f"{len(outs)} sample(s) in {dt:.1f}s (saved to {save_dir})",
                    images_b64=[_png_b64(o) for o in outs]))
            except Exception as e:  # report it and keep serving
                self._send(500, render_form(state, message=f"error: {e}"))
            finally:
                if init_path:
                    os.unlink(init_path)

    return Handler


def parse_versions(args) -> Dict[str, Dict[str, str]]:
    """``--version name=config[:ckpt]`` entries; ``--config_path`` is the
    default version, named after the file (or the built-in config)."""
    versions: Dict[str, Dict[str, str]] = {}
    if args.config_path:
        versions[Path(args.config_path).stem] = {"config": args.config_path,
                                                 "ckpt": args.ckpt_path}
    for spec in args.version or []:
        name, _, rest = spec.partition("=")
        config, _, ckpt = rest.partition(":")
        versions[name] = {"config": config, "ckpt": ckpt}
    if not versions:
        raise SystemExit("pass --config_path or at least one --version")
    return versions


def serve(state: DemoState, host: str, port: int) -> HTTPServer:
    return HTTPServer((host, port), make_handler(state))


def parser() -> argparse.ArgumentParser:
    p = add_image_args(argparse.ArgumentParser(), config_required=False)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--version", action="append", default=[],
                   help="extra model version: name=config.yaml[:ckpt]")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    state = DemoState(args, parse_versions(args))
    server = serve(state, args.host, args.port)
    print(f"[demo] serving on http://{args.host}:{server.server_address[1]} "
          f"(versions: {', '.join(state.versions)})", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
