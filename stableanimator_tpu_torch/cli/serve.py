"""HTTP inference server (port of the JAX package's `cli/serve.py`): a
long-lived process that keeps the models on the card and answers requests,
stdlib-only (http.server), one device per process:

  python -m stableanimator_tpu_torch.cli.serve --checkpoint_dir ckpts \\
      --height 512 --width 512 --port 8000 [--allow_random_init] [--warm]

Endpoints:
  GET  /healthz   -> {"ok": true, "device": ..., "requests_served": N}
  POST /animate   -> animation bytes. JSON body:
      {
        "reference": "<base64 PNG/JPEG>",
        "poses": ["<base64 PNG>", ...],          # one per frame
        "format": "mp4" | "gif" | "json",        # default mp4
        "seed": int,                             # free per-request knob
        # overrides gated by --allow_shape_overrides (see below):
        "height": int, "width": int, "num_inference_steps": int,
        "tile_size": int, "frames_overlap": int, "decode_chunk_size": int,
        "guidance_scale": float, "max_tile_batch": int   # 0 = auto
      }
    Responds video/mp4 or image/gif bytes; "json" returns
    {"mp4": "<base64>", "seconds": t, "frames": F}. Errors are JSON with
    HTTP 4xx/5xx.

Hardening, as in the JAX package (there a new shape costs a compile under
the device lock; here it costs new allocations and kernel choices, and the
allowlist keeps the memory a request may take bounded):
  * request bodies above --max_request_mb are rejected 413 before the body
    is read;
  * height/width must come from the --shape_buckets allowlist (default: the
    server's own config); anything else is 400;
  * the other config overrides (steps/tile/overlap/decode chunk/guidance/
    max_tile_batch) are rejected 400 unless --allow_shape_overrides is set;
    seed/format stay free;
  * the frame count is capped by --max_frames (413 above it).

Generation is serialised with a lock (one device per server process); scale
out with one process per card behind any HTTP balancer. The models load once
at startup, as in cli/animate.py (`build_models` + `load_state_dicts`, bf16
with the fp32 islands: norm affines, the VAE encoder), with the antelopev2
face model when its files are in <checkpoint_dir>/antelopev2.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="StableAnimator server (PyTorch port)")
    p.add_argument("--checkpoint_dir", type=str, required=True)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--num_inference_steps", type=int, default=25)
    p.add_argument("--tile_size", type=int, default=16)
    p.add_argument("--frames_overlap", type=int, default=4)
    p.add_argument("--decode_chunk_size", type=int, default=4)
    p.add_argument("--guidance_scale", type=float, default=3.0)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--allow_random_init", action="store_true")
    p.add_argument("--model_scale", type=str, default="full", choices=["full", "micro"])
    p.add_argument("--init_id_adapter", action="store_true")
    p.add_argument("--warm", action="store_true",
                   help="run one generation per allowlisted shape before accepting "
                        "traffic (first-request latency becomes steady-state latency)")
    p.add_argument("--max_request_mb", type=int, default=256,
                   help="reject request bodies larger than this (HTTP 413) before "
                        "reading them")
    p.add_argument("--max_frames", type=int, default=900,
                   help="reject requests with more pose frames than this (HTTP 413); "
                        "900 = 2x the reference's 15s demo")
    p.add_argument("--shape_buckets", type=str, default=None,
                   help="comma-separated HxW allowlist for per-request height/width "
                        "(e.g. '512x512,576x1024'); default = the server's own "
                        "--height x --width only. Requests outside the list get HTTP 400.")
    p.add_argument("--allow_shape_overrides", action="store_true",
                   help="allow per-request overrides of the other config knobs "
                        "(steps/tile/overlap/decode chunk/guidance/max_tile_batch)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


#: request keys that override the request's config (gated)
_COMPILE_KEYS = ("num_inference_steps", "tile_size", "frames_overlap",
                 "decode_chunk_size", "guidance_scale", "max_tile_batch")


def _parse_buckets(args):
    """-> set of allowed (h, w) pairs from --shape_buckets/--height/--width."""
    buckets = {(args.height, args.width)}
    if args.shape_buckets:
        for tok in args.shape_buckets.split(","):
            h, w = tok.strip().lower().split("x")
            buckets.add((int(h), int(w)))
    return buckets


class RequestRejected(ValueError):
    """Client error carrying its HTTP status (400/413)."""

    def __init__(self, status, msg):
        super().__init__(msg)
        self.status = status


class AnimationService:
    """Owns the models and serialises device access."""

    def __init__(self, args):
        from stableanimator_tpu_torch.convert.checkpoints import load_state_dicts
        from stableanimator_tpu_torch.core.config import micro_model_kwargs
        from stableanimator_tpu_torch.pipeline.animation import build_models, resolve_device
        from stableanimator_tpu_torch.preproc.face import FaceModel

        self.args = args
        self.torch_device = resolve_device(args.device)
        model_kwargs = dict(dtype=torch.bfloat16, device=self.torch_device)
        if args.model_scale == "micro":
            model_kwargs.update(micro_model_kwargs(), dtype=torch.float32)
        self.models = build_models(**model_kwargs)
        load_state_dicts(args.checkpoint_dir, self.models, args.allow_random_init,
                         init_id_adapter=args.init_id_adapter)
        det = os.path.join(args.checkpoint_dir, "antelopev2", "scrfd_10g_bnkps.onnx")
        rec = os.path.join(args.checkpoint_dir, "antelopev2", "glintr100.onnx")
        self.face_model = (FaceModel(det, rec, device=self.torch_device)
                           if os.path.exists(det) and os.path.exists(rec) else None)
        self.id_dim = self.models.face_encoder.config.id_embeddings_dim
        self.lock = threading.Lock()
        self.requests_served = 0
        self.device = (torch.cuda.get_device_name(self.torch_device)
                       if self.torch_device.type == "cuda" else str(self.torch_device))
        self.shape_buckets = _parse_buckets(args)

    # -- request handling ---------------------------------------------------

    def _decode_image(self, b64: str, size=None):
        from PIL import Image

        img = Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")
        if size is not None:
            img = img.resize(size)
        return img

    def animate(self, req: dict) -> dict:
        from stableanimator_tpu_torch.core.config import PipelineConfig
        from stableanimator_tpu_torch.pipeline.animation import generate
        from stableanimator_tpu_torch.utils.image import (
            export_to_gif,
            export_to_mp4,
            frames_to_uint8,
            pil_to_u8_array,
        )

        a = self.args
        h = int(req.get("height", a.height))
        w = int(req.get("width", a.width))
        poses_b64 = req.get("poses") or []
        if not req.get("reference") or not poses_b64:
            raise ValueError("body needs 'reference' and non-empty 'poses'")
        if h % 64 or w % 64:
            raise ValueError("height/width must be multiples of 64")
        if (h, w) not in self.shape_buckets:
            raise RequestRejected(
                400, f"shape {h}x{w} not in the server's allowlist "
                     f"{sorted(self.shape_buckets)}; start the server with "
                     f"--shape_buckets to pre-approve (and --warm to warm) more buckets")
        if len(poses_b64) > a.max_frames:
            raise RequestRejected(
                413, f"{len(poses_b64)} frames exceeds --max_frames={a.max_frames}")
        if not a.allow_shape_overrides:
            blocked = [k for k in _COMPILE_KEYS if k in req]
            if blocked:
                raise RequestRejected(
                    400, f"override of {blocked} is disabled; start the server with "
                         f"--allow_shape_overrides to permit")

        ref = self._decode_image(req["reference"])
        ref_sized = ref.resize((w, h))
        poses = [self._decode_image(b, size=(w, h)) for b in poses_b64]
        pose_u8 = np.stack([np.asarray(p, np.uint8) for p in poses])

        emb = None
        if self.face_model is not None:
            emb = self.face_model.get_id_embedding(
                np.asarray(ref)[..., ::-1])  # the reference's channel-order quirk
        if emb is None:
            emb = np.zeros((self.id_dim,), np.float32)
        emb = np.resize(emb.astype(np.float32), (self.id_dim,))

        f = len(poses)
        tile = min(int(req.get("tile_size", a.tile_size)), f)
        g = float(req.get("guidance_scale", a.guidance_scale))
        cfg = PipelineConfig(
            height=h, width=w, num_frames=f, tile_size=tile,
            tile_overlap=min(int(req.get("frames_overlap", a.frames_overlap)),
                             max(tile - 1, 1)),
            num_inference_steps=int(req.get("num_inference_steps", a.num_inference_steps)),
            min_guidance_scale=g, max_guidance_scale=g,
            decode_chunk_size=int(req.get("decode_chunk_size", a.decode_chunk_size)),
            max_tile_batch=("auto" if int(req.get("max_tile_batch", 0)) == 0
                            else int(req["max_tile_batch"])),
            output_uint8=True,   # uint8 on the device: 1/4 the copy to the host
        )
        seed = int(req.get("seed", 23123134))

        t0 = time.time()
        with self.lock:  # one generation at a time on the device
            dev = self.torch_device
            frames = generate(
                self.models, torch.tensor(pil_to_u8_array(ref_sized)),
                torch.from_numpy(pose_u8), torch.from_numpy(emb[None]), cfg,
                clip_image=torch.tensor(pil_to_u8_array(ref)),
                generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
            u8 = frames_to_uint8(frames.cpu().numpy())
        seconds = time.time() - t0
        self.requests_served += 1

        fmt = req.get("format", "mp4")
        suffix = ".gif" if fmt == "gif" else ".mp4"
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "out" + suffix)
            if fmt == "gif":
                export_to_gif(u8, path)
            else:
                export_to_mp4(u8, path, fps=a.fps)
            with open(path, "rb") as fh:
                body = fh.read()
        if fmt == "gif":
            return {"content_type": "image/gif", "body": body, "seconds": seconds}
        if fmt == "json":
            return {"content_type": "application/json",
                    "body": json.dumps({"mp4": base64.b64encode(body).decode(),
                                        "seconds": round(seconds, 3), "frames": f}).encode(),
                    "seconds": seconds}
        return {"content_type": "video/mp4", "body": body, "seconds": seconds}

    def warm(self):
        """One request per allowlisted bucket before accepting traffic."""
        from PIL import Image

        for h, w in sorted(self.shape_buckets):
            blank = _pil_b64(Image.new("RGB", (w, h), (127, 127, 127)))
            self.animate({"reference": blank, "poses": [blank] * self.args.tile_size,
                          "height": h, "width": w, "format": "json"})
            self.requests_served -= 1  # warmup is not traffic


def _pil_b64(img):
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def make_handler(service: AnimationService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet: one line per request below
            pass

        def _send(self, code, content_type, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, "application/json", json.dumps({
                    "ok": True, "device": service.device,
                    "requests_served": service.requests_served}).encode())
            else:
                self._send(404, "application/json", b'{"error":"not found"}')

        def do_POST(self):
            if self.path != "/animate":
                self._send(404, "application/json", b'{"error":"not found"}')
                return
            try:
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    n = -1
                if n < 0:
                    raise RequestRejected(400, "missing/invalid Content-Length")
                limit = service.args.max_request_mb * 1024 * 1024
                if n > limit:  # reject BEFORE reading the body
                    raise RequestRejected(
                        413, f"request body {n} bytes exceeds "
                             f"--max_request_mb={service.args.max_request_mb}")
                req = json.loads(self.rfile.read(n) or b"{}")
                out = service.animate(req)
                print(f"[serve] /animate {len(req.get('poses') or [])}f "
                      f"in {out['seconds']:.1f}s", flush=True)
                self._send(200, out["content_type"], out["body"])
            except RequestRejected as e:
                self._send(e.status, "application/json",
                           json.dumps({"error": str(e)}).encode())
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                self._send(400, "application/json", json.dumps({"error": str(e)}).encode())
            except Exception as e:  # surface, never crash the server
                self._send(500, "application/json",
                           json.dumps({"error": f"{type(e).__name__}: {e}"}).encode())

    return Handler


def main(argv=None):
    args = parse_args(argv)
    service = AnimationService(args)
    if args.warm:
        print("[serve] warming the allowlisted shapes ...", flush=True)
        t0 = time.time()
        service.warm()
        print(f"[serve] warm in {time.time() - t0:.1f}s", flush=True)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(service))
    print(f"[serve] listening on http://{args.host}:{args.port} "
          f"(device {service.device})", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
