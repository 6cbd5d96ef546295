"""The port's HTTP server (`stableanimator_tpu_torch.cli.serve`) on the CPU.

  * the hardening (400 / 413 / allowlist / --max_frames, tests/test_serve.py)
    against the JAX package's handler: the same requests get the same status
    codes from both, with services that hold no models (every request here
    is rejected before any model would run);
  * an in-process micro server (ThreadingHTTPServer on 127.0.0.1, port 0)
    with the stand-in antelopev2 files, driven through http.client: its mp4
    is byte for byte the one written from the port's `generate` on the same
    inputs, identity embedding and seed.
"""

import base64
import http.client
import io
import json
import os
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from stableanimator_tpu.cli import serve as jax_serve
from stableanimator_tpu_torch.cli import serve
from stableanimator_tpu_torch.core.config import PipelineConfig, micro_model_kwargs
from stableanimator_tpu_torch.pipeline.animation import build_models, generate
from stableanimator_tpu_torch.preproc.face import FaceModel
from stableanimator_tpu_torch.preproc.standins import seeded_iresnet, write_antelopev2
from stableanimator_tpu_torch.utils.image import export_to_mp4, frames_to_uint8, pil_to_u8_array
from tests.torch_threads import share_cores

THREADS = share_cores()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes at once, and torch's thread pools then spend their time
    waiting for each other on these small shapes."""
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(THREADS)


def _b64_png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _start(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _request(addr, method, path, body=None, raw=None, headers=None):
    conn = http.client.HTTPConnection(*addr, timeout=600)
    if raw is not None:
        conn.putrequest(method, path)
        for k, v in (headers or {}).items():
            conn.putheader(k, v)
        conn.endheaders()
        if raw:
            conn.send(raw)
    else:
        conn.request(method, path, body=json.dumps(body) if body is not None else None,
                     headers={"Content-Type": "application/json"} if body is not None else {})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


ARGV = ["--checkpoint_dir", "none", "--height", "64", "--width", "64", "--max_frames", "8",
        "--max_request_mb", "1"]


class _Stub:
    """A service without models: the real `animate` validation runs on it."""

    def __init__(self, module, argv):
        self.args = module.parse_args(argv)
        self.shape_buckets = module._parse_buckets(self.args)
        self.requests_served = 0
        self.device = "stub"
        self.animate = lambda req: module.AnimationService.animate(self, req)


REF = _b64_png(np.zeros((64, 64, 3), np.uint8))
REJECTED = {
    "no_reference": {"poses": []},
    "bad_size": {"reference": REF, "poses": [REF], "height": 100},
    "not_in_allowlist": {"reference": REF, "poses": [REF], "height": 128, "width": 128},
    "steps_override": {"reference": REF, "poses": [REF], "num_inference_steps": 50},
    "guidance_override": {"reference": REF, "poses": [REF], "guidance_scale": 9.5},
    "too_many_frames": {"reference": REF, "poses": [REF] * 9},
}


@pytest.fixture(scope="module")
def stub_servers():
    servers = {name: _start(module.make_handler(_Stub(module, ARGV)))
               for name, module in (("port", serve), ("jax", jax_serve))}
    yield {k: s.server_address for k, s in servers.items()}
    for s in servers.values():
        s.shutdown()


@pytest.mark.parametrize("case", list(REJECTED))
def test_rejections_match_the_jax_handler(stub_servers, case):
    got = _request(stub_servers["port"], "POST", "/animate", REJECTED[case])
    want = _request(stub_servers["jax"], "POST", "/animate", REJECTED[case])
    assert got[0] == want[0] and got[0] in (400, 413), (got, want)
    assert got[1] == "application/json"
    key = {"no_reference": b"reference", "bad_size": b"multiples of 64",
           "not_in_allowlist": b"allowlist", "steps_override": b"num_inference_steps",
           "guidance_override": b"guidance_scale", "too_many_frames": b"max_frames"}[case]
    assert key in got[2]


@pytest.mark.parametrize("case", ["oversized_body", "bad_content_length", "bad_json",
                                  "unknown_post", "unknown_get", "healthz"])
def test_transport_errors_match_the_jax_handler(stub_servers, case):
    def send(addr):
        if case == "oversized_body":      # a 1 TB claim dies before the read
            return _request(addr, "POST", "/animate", raw=b"",
                            headers={"Content-Type": "application/json",
                                     "Content-Length": str(10**12)})
        if case == "bad_content_length":
            return _request(addr, "POST", "/animate", raw=b"",
                            headers={"Content-Length": "abc"})
        if case == "bad_json":
            return _request(addr, "POST", "/animate", raw=b"{nope",
                            headers={"Content-Length": "5"})
        if case == "unknown_post":
            return _request(addr, "POST", "/nope", {})
        return _request(addr, "GET", "/healthz" if case == "healthz" else "/nope")

    got, want = send(stub_servers["port"]), send(stub_servers["jax"])
    assert got[0] == want[0], (got, want)
    if case == "oversized_body":
        assert got[0] == 413 and b"max_request_mb" in got[2]
    if case == "healthz":
        rec = json.loads(got[2])
        assert rec["ok"] and rec["requests_served"] == 0 and "device" in rec


def test_max_frames_cap():
    svc = _Stub(serve, ARGV)
    with pytest.raises(serve.RequestRejected) as exc:
        serve.AnimationService.animate(svc, {"reference": "x", "poses": ["y"] * 9})
    assert exc.value.status == 413 and "max_frames" in str(exc.value)


def test_shape_buckets_parsing():
    argv = ["--checkpoint_dir", "/tmp", "--height", "512", "--width", "512",
            "--shape_buckets", "576x1024, 512X512"]
    assert serve._parse_buckets(serve.parse_args(argv)) == {(512, 512), (576, 1024)}
    assert serve._parse_buckets(serve.parse_args(argv)) == \
        jax_serve._parse_buckets(jax_serve.parse_args(argv))
    assert serve.parse_args(argv).device == "cuda"


# ---------------------------------------------------------------------------
# a real micro server on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def micro_server(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    write_antelopev2(str(ckpt / "antelopev2"),
                     recogniser=seeded_iresnet(0, layers=(1, 1, 1, 1), widths=(8, 8, 16, 16),
                                               num_features=32))
    args = serve.parse_args([
        "--checkpoint_dir", str(ckpt), "--allow_random_init", "--model_scale", "micro",
        "--height", "64", "--width", "64", "--num_inference_steps", "2", "--tile_size", "4",
        "--frames_overlap", "1", "--decode_chunk_size", "2", "--port", "0", "--device", "cpu"])
    service = serve.AnimationService(args)
    httpd = _start(serve.make_handler(service))
    yield httpd.server_address, service, ckpt
    httpd.shutdown()


def test_micro_server_frames_equal_generate(micro_server):
    addr, service, ckpt = micro_server
    assert service.face_model is not None and service.device == "cpu"
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
    poses = []
    for i in range(4):
        img = np.zeros((64, 64, 3), np.uint8)
        img[10 + i * 5:30 + i * 5, 20:40] = 255
        poses.append(img)
    body = {"reference": _b64_png(ref), "poses": [_b64_png(p) for p in poses], "seed": 7}

    status, ctype, data = _request(addr, "POST", "/animate", body)
    assert status == 200 and ctype == "video/mp4", data[:300]
    assert len(data) > 200 and b"ftyp" in data[:64]
    status, ctype, js = _request(addr, "POST", "/animate", dict(body, format="json"))
    assert status == 200 and ctype == "application/json"
    rec = json.loads(js)
    assert rec["frames"] == 4 and base64.b64decode(rec["mp4"]) == data
    status, _, health = _request(addr, "GET", "/healthz")
    assert json.loads(health)["requests_served"] == 2

    # the same request through generate
    det = os.path.join(ckpt, "antelopev2", "scrfd_10g_bnkps.onnx")
    rec_path = os.path.join(ckpt, "antelopev2", "glintr100.onnx")
    emb = FaceModel(det, rec_path, device="cpu").get_id_embedding(ref[..., ::-1])
    assert emb is not None and emb.shape == (32,) and np.abs(emb).max() > 0
    models = build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu")
    cfg = PipelineConfig(height=64, width=64, num_frames=4, tile_size=4, tile_overlap=1,
                         num_inference_steps=2, decode_chunk_size=2, output_uint8=True)
    ref_u8 = torch.tensor(pil_to_u8_array(Image.fromarray(ref)))     # [1, H, W, 3]
    frames = generate(models, ref_u8, torch.from_numpy(np.stack(poses)),
                      torch.from_numpy(emb[None].astype(np.float32)), cfg,
                      clip_image=ref_u8,
                      generator=torch.Generator().manual_seed(7), device="cpu")
    assert frames.float().std() > 1.0
    out = ckpt / "want.mp4"
    export_to_mp4(frames_to_uint8(frames.numpy()), str(out), fps=8)
    assert out.read_bytes() == data
