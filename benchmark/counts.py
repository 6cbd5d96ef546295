"""The benchmark's own count of the work in a request or a training step,
from a configuration file's published widths and a cell's shapes; the
program's counters are not read.

What follows is the SVD family's count (a configuration file without a
`"family"` key). A configuration with `"family": "<name>"` is counted by
`benchmark/families/<name>.py` (`common.family`): `model_flops` and
`attention_calls` return its answer, made of the same call dicts that
`call_work` and `bound_seconds` read.

Model FLOPs: 2 M N K for every matrix product and convolution the model's
math needs (an attention is two products: 4 B H Sq Sk D), biases,
normalisations and elementwise work not counted. A request is the UNet at
batch 2 (classifier-free guidance) x frames per Euler step, the temporal VAE
decoder over the frames, the VAE encoder over the reference image, CLIP,
PoseNet over the frames and the face encoder; a training step is three
times the forward of the trained UNet, PoseNet and face encoder (forward and
backward) and once the frozen VAE encoder (clip and reference frame) and
CLIP. Recomputation under gradient checkpointing is not model work.
Operations in float32 (the VAE encoder) count at the bf16 peak like the rest.

Attention kernel work: each attention call that the shapes contain and that
the program's routing sends to a flash kernel (16-bit, at least 512 keys
and 128 queries: the UNet's spatial self-attention at such levels, the VAE
decoder's mid attention). Forward 4 B H Sq Sk D operations, backward 2.5
times that (five products: the scores again, dP, dV, dQ, dK); bytes: each
input read once and each output written once (q, k, v, o in 16 bits, the
log-sum-exp in float32). Under gradient checkpointing the training step
runs each forward twice.
"""

from __future__ import annotations

import json
from pathlib import Path

from benchmark import common

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
FLASH_MIN_KEYS, FLASH_MIN_QUERIES = 512, 128


def _conv(n, h, w, cin, cout, k):
    return 2 * n * h * w * cin * cout * k


def _lin(rows, a, b):
    return 2 * rows * a * b


def _attn(b, sq, sk, width):
    return 4 * b * sq * sk * width


def unet_flops(u: dict, b: int, f: int, h: int, w: int) -> int:
    """One UNet call on b videos of f frames at latent h x w."""
    ch, heads, lpb = u["block_out_channels"], u["num_attention_heads"], u["layers_per_block"]
    cross, n_id = u["cross_attention_dim"], u["num_id_tokens"]
    temb = 4 * ch[0]
    n = b * f
    total = _conv(n, h, w, u["in_channels"], ch[0], 9)
    total += _lin(b, ch[0], temb) + _lin(b, temb, temb)
    total += _lin(b, u["projection_class_embeddings_input_dim"], temb) + _lin(b, temb, temb)

    def res(cin, cout, hh, ww):
        out = _conv(n, hh, ww, cin, cout, 9) + _conv(n, hh, ww, cout, cout, 9)
        out += _conv(n, hh, ww, cin, cout, 1) if cin != cout else 0
        out += 2 * _conv(n, hh, ww, cout, cout, 3)         # temporal (3, 1, 1) pair
        return out + 2 * _lin(n, temb, cout)

    def transformer(c, hh, ww):
        s = hh * ww
        t = n * s
        out = 2 * _lin(t, c, c) + _lin(n, c, 4 * c) + _lin(n, 4 * c, c)   # proj in/out, frame emb
        out += 4 * _lin(t, c, c) + _attn(n, s, s, c)                      # spatial self-attention
        out += 2 * _lin(t, c, c) + _lin(n, cross, c)                      # ID attention: q, out, CLIP v
        out += 2 * _lin(n * n_id, cross, c) + _attn(n, s, n_id, c)        # face tokens
        out += 3 * (_lin(t, c, 8 * c) + _lin(t, 4 * c, c))                # ff_in, two ff
        out += 4 * _lin(t, c, c) + _attn(b * s, f, f, c)                  # temporal self-attention
        out += _lin(n, cross, c) + _lin(n, c, c)                          # temporal cross (one key)
        return out

    skips, cin = [ch[0]], ch[0]
    for i, c in enumerate(ch):
        hh, ww = h >> i, w >> i
        for j in range(lpb):
            total += res(cin if j == 0 else c, c, hh, ww)
            total += transformer(c, hh, ww) if i < len(ch) - 1 else 0
        skips += [c] * lpb
        if i < len(ch) - 1:
            total += _conv(n, hh // 2, ww // 2, c, c, 9)
            skips.append(c)
        cin = c
    hh, ww = h >> (len(ch) - 1), w >> (len(ch) - 1)
    total += 2 * res(ch[-1], ch[-1], hh, ww) + transformer(ch[-1], hh, ww)
    for i, c in enumerate(ch[::-1]):
        level = len(ch) - 1 - i
        hh, ww = h >> level, w >> level
        for j in range(lpb + 1):
            total += res((cin if j == 0 else c) + skips.pop(), c, hh, ww)
            total += transformer(c, hh, ww) if i > 0 else 0
        if i < len(ch) - 1:
            total += _conv(n, 2 * hh, 2 * ww, c, c, 9)
        cin = c
    return total + _conv(n, h, w, ch[0], u["out_channels"], 9)


def _vae_attn(n, s, c):
    return 4 * _lin(n * s, c, c) + _attn(n, s, s, c)


def vae_decode_flops(v: dict, f: int, h: int, w: int) -> int:
    """The temporal decoder over f frames at latent h x w."""
    ch, lpb = v["block_out_channels"], v["layers_per_block"]

    def st(cin, cout, hh, ww):
        out = _conv(f, hh, ww, cin, cout, 9) + _conv(f, hh, ww, cout, cout, 9)
        out += _conv(f, hh, ww, cin, cout, 1) if cin != cout else 0
        return out + 2 * _conv(f, hh, ww, cout, cout, 3)

    total = _conv(f, h, w, v["latent_channels"], ch[-1], 9)
    total += 2 * st(ch[-1], ch[-1], h, w) + _vae_attn(f, h * w, ch[-1])
    prev, hh, ww = ch[-1], h, w
    for i, c in enumerate(ch[::-1]):
        for j in range(lpb + 1):
            total += st(prev if j == 0 else c, c, hh, ww)
        if i < len(ch) - 1:
            hh, ww = 2 * hh, 2 * ww
            total += _conv(f, hh, ww, c, c, 9)
        prev = c
    total += _conv(f, hh, ww, ch[0], v["out_channels"], 9)
    return total + _conv(f, hh, ww, v["out_channels"], v["out_channels"], 3)


def vae_encode_flops(v: dict, n: int, height: int, width: int) -> int:
    """The encoder and quant_conv over n images."""
    ch, lpb, lat = v["block_out_channels"], v["layers_per_block"], v["latent_channels"]
    total = _conv(n, height, width, v["in_channels"], ch[0], 9)
    cin, hh, ww = ch[0], height, width
    for i, c in enumerate(ch):
        for j in range(lpb):
            total += _conv(n, hh, ww, cin if j == 0 else c, c, 9) + _conv(n, hh, ww, c, c, 9)
            total += _conv(n, hh, ww, cin, c, 1) if j == 0 and cin != c else 0
        if i < len(ch) - 1:
            hh, ww = hh // 2, ww // 2
            total += _conv(n, hh, ww, c, c, 9)
        cin = c
    total += 2 * 2 * _conv(n, hh, ww, ch[-1], ch[-1], 9) + _vae_attn(n, hh * ww, ch[-1])
    return total + _conv(n, hh, ww, ch[-1], 2 * lat, 9) + _conv(n, hh, ww, 2 * lat, 2 * lat, 1)


def clip_flops(c: dict, n: int = 1) -> int:
    p = c["image_size"] // c["patch_size"]
    t, d, inner = p * p + 1, c["hidden_size"], c["intermediate_size"]
    total = _conv(n, p, p, 3, d, c["patch_size"] ** 2)
    layer = 4 * _lin(n * t, d, d) + _attn(n, t, t, d) + 2 * _lin(n * t, d, inner)
    return total + c["num_hidden_layers"] * layer + _lin(n, d, c["projection_dim"])


def pose_flops(p: dict, n: int, height: int, width: int) -> int:
    c = p["conv_channels"]
    specs = [(c[0], c[0], 3, 1), (c[0], c[1], 4, 2), (c[1], c[1], 3, 1), (c[1], c[2], 4, 2),
             (c[2], c[2], 3, 1), (c[2], c[3], 4, 2), (c[3], c[3], 3, 1), (c[3], c[4], 3, 1)]
    total, hh, ww = 0, height, width
    for cin, cout, k, s in specs:
        hh, ww = hh // s, ww // s
        total += _conv(n, hh, ww, cin, cout, k * k)
    return total + _conv(n, hh, ww, c[4], p["noise_latent_channels"], 1)


def face_flops(fe: dict, n: int = 1) -> int:
    d, idd, nt = fe["cross_attention_dim"], fe["id_embeddings_dim"], fe["num_tokens"]
    total = _lin(n, idd, 2 * idd) + _lin(n, 2 * idd, d * nt) + _lin(n, fe["clip_embeddings_dim"], d)
    layer = (_lin(n * nt, d, d) + _lin(n * (nt + 1), d, 2 * d) + _attn(n, nt, nt + 1, d)
             + _lin(n * nt, d, d) + 2 * _lin(n * nt, d, d * fe["ff_mult"]))
    return total + fe["depth"] * layer + _lin(n * nt, d, d)


def model_flops(cfg: dict, work: dict) -> int:
    """Model FLOPs of one unit of work (a driver's `work()`)."""
    family = common.family(cfg)
    if family is not None:
        return family.model_flops(cfg, work)
    m = cfg["models"]
    f, hh, ww = work["frames"], work["height"], work["width"]
    h8, w8 = hh // 8, ww // 8
    if work["kind"] == "request":
        return (work["steps"] * unet_flops(m["unet"], 2, f, h8, w8)
                + vae_decode_flops(m["vae"], f, h8, w8) + vae_encode_flops(m["vae"], 1, hh, ww)
                + clip_flops(m["clip"]) + pose_flops(m["pose_net"], f, hh, ww)
                + face_flops(m["face_encoder"]))
    b = work["clips"]
    trained = (unet_flops(m["unet"], b, f, h8, w8) + pose_flops(m["pose_net"], b * f, hh, ww)
               + face_flops(m["face_encoder"], b))
    return 3 * trained + vae_encode_flops(m["vae"], b * (f + 1), hh, ww) + clip_flops(m["clip"], b)


def _routed(sq: int, sk: int) -> bool:
    return sk >= FLASH_MIN_KEYS and sq >= FLASH_MIN_QUERIES


def attention_calls(cfg: dict, work: dict) -> list[dict]:
    """The flash-routed attention calls of one unit of work:
    [{"pass": "fwd" | "bwd", "b", "sq", "sk", "h", "d", "lse", "n"}]."""
    family = common.family(cfg)
    if family is not None:
        return family.attention_calls(cfg, work)
    m = cfg["models"]
    u, v = m["unet"], m["vae"]
    f, h8, w8 = work["frames"], work["height"] // 8, work["width"] // 8
    ch, heads, lpb = u["block_out_channels"], u["num_attention_heads"], u["layers_per_block"]
    per_call = []                     # (tokens, heads, head dim, transformers at that level)
    for i, c in enumerate(ch):
        s = (h8 >> i) * (w8 >> i)
        n = (2 * lpb + 1) if i < len(ch) - 1 else 1
        if _routed(s, s):
            per_call.append((s, heads[i], c // heads[i], n))
    calls = []
    if work["kind"] == "request":
        b = 2 * f
        for s, hd, d, n in per_call:
            calls.append(dict(**{"pass": "fwd"}, b=b, sq=s, sk=s, h=hd, d=d, lse=False,
                              n=n * work["steps"]))
        s = h8 * w8
        if _routed(s, s):
            chunk = min(work["decode_chunk"], f)
            if f * s <= work["batched_decode_max_latent_volume"]:
                groups = [(f // chunk) * chunk] + ([f % chunk] if f % chunk else [])
            else:
                groups = [chunk] * (f // chunk) + ([f % chunk] if f % chunk else [])
            for g in groups:
                calls.append(dict(**{"pass": "fwd"}, b=g, sq=s, sk=s, h=1,
                                  d=v["block_out_channels"][-1], lse=False, n=1))
        return calls
    b = work["clips"] * f
    fwd = 2 if work["checkpointing"] else 1
    for s, hd, d, n in per_call:
        calls.append(dict(**{"pass": "fwd"}, b=b, sq=s, sk=s, h=hd, d=d, lse=True, n=n * fwd))
        calls.append(dict(**{"pass": "bwd"}, b=b, sq=s, sk=s, h=hd, d=d, lse=True, n=n))
    return calls


def call_work(call: dict) -> tuple[float, float]:
    """(operations, bytes) of one attention call."""
    b, sq, sk, h, d = call["b"], call["sq"], call["sk"], call["h"], call["d"]
    ops = 4.0 * b * h * sq * sk * d
    q, kv = 2.0 * b * sq * h * d, 2.0 * b * sk * h * d
    lse = 4.0 * b * sq * h if call["lse"] else 0.0
    if call["pass"] == "fwd":
        return ops, q + 2 * kv + q + lse                          # q, k, v in; o (and lse) out
    return 2.5 * ops, (q + 2 * kv + 2 * q + lse) + (q + 2 * kv)   # q, k, v, o, dO, lse; dq, dk, dv


def bound_seconds(call: dict) -> float:
    """The least time of one call on the card: the larger of its operations
    at the bf16 peak and its bytes at the memory peak."""
    ops, nbytes = call_work(call)
    return max(ops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_per_s"])
