"""First-party MP4 muxer (Motion-JPEG video track): a copy of the JAX
package's `utils/mp4.py`, which uses no JAX.

The reference writes its artifact with OpenCV's VideoWriter
(inference_basic.py:56-64). This module writes a standards-conforming ISO
BMFF (MP4) file from uint8 RGB frames with nothing beyond PIL's JPEG
encoder:

  * one video track, sample entry 'jpeg' (ISO/IEC 14496-12 Motion JPEG —
    each sample is a complete JFIF image; decoded by ffmpeg/VLC/QuickTime),
  * ftyp + mdat + moov(mvhd, trak(tkhd, mdia(mdhd, hdlr, minf(vmhd, dinf,
    stbl(stsd, stts, stsc, stsz, stco))))),
  * every sample a sync sample (no stss needed).

cv2's mp4v encoder compresses better (inter-frame), so utils/image.py uses
it when importable and falls back here.
"""

from __future__ import annotations

import io
import struct
from typing import List

import numpy as np

_TIMESCALE = 600  # classic MP4 movie timescale; divisible by 8, 24, 30 fps


def _box(kind: bytes, *payloads: bytes) -> bytes:
    body = b"".join(payloads)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full(kind: bytes, version: int, flags: int, *payloads: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *payloads)


def _matrix_identity() -> bytes:
    return struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _jpeg_sample_entry(w: int, h: int) -> bytes:
    return _box(
        b"jpeg",
        b"\x00" * 6,                      # reserved
        struct.pack(">H", 1),             # data_reference_index
        b"\x00" * 16,                     # pre_defined/reserved
        struct.pack(">HH", w, h),
        struct.pack(">II", 0x00480000, 0x00480000),  # 72 dpi
        struct.pack(">I", 0),             # reserved
        struct.pack(">H", 1),             # frame_count
        b"\x00" * 32,                     # compressorname
        struct.pack(">Hh", 24, -1),       # depth, pre_defined
    )


def write_mp4_mjpeg(frames: List[np.ndarray], path: str, fps: int = 8,
                    quality: int = 90) -> None:
    """Write uint8 RGB HWC frames as an MJPEG .mp4."""
    from PIL import Image

    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    samples = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(f)).save(
            buf, format="JPEG", quality=quality)
        samples.append(buf.getvalue())

    n = len(samples)
    dur = _TIMESCALE // fps
    total_dur = dur * n

    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200),
                b"isom", b"iso2", b"mp41")
    # mdat follows ftyp; chunk offsets are absolute file offsets
    mdat_payload = b"".join(samples)
    mdat = _box(b"mdat", mdat_payload)
    first_sample_off = len(ftyp) + 8  # mdat header is 8 bytes

    offs, pos = [], first_sample_off
    for s in samples:
        offs.append(pos)
        pos += len(s)

    stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), _jpeg_sample_entry(w, h))
    stts = _full(b"stts", 0, 0, struct.pack(">I", 1),
                 struct.pack(">II", n, dur))
    stsc = _full(b"stsc", 0, 0, struct.pack(">I", 1),
                 struct.pack(">III", 1, 1, 1))  # one sample per chunk
    stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, n),
                 b"".join(struct.pack(">I", len(s)) for s in samples))
    stco = _full(b"stco", 0, 0, struct.pack(">I", n),
                 b"".join(struct.pack(">I", o) for o in offs))
    stbl = _box(b"stbl", stsd, stts, stsc, stsz, stco)

    dref = _full(b"dref", 0, 0, struct.pack(">I", 1),
                 _full(b"url ", 0, 1))    # self-contained
    dinf = _box(b"dinf", dref)
    vmhd = _full(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
    minf = _box(b"minf", vmhd, dinf, stbl)
    hdlr = _full(b"hdlr", 0, 0, struct.pack(">I", 0), b"vide",
                 b"\x00" * 12, b"VideoHandler\x00")
    mdhd = _full(b"mdhd", 0, 0,
                 struct.pack(">IIII", 0, 0, _TIMESCALE, total_dur),
                 struct.pack(">HH", 0x55C4, 0))  # language 'und'
    mdia = _box(b"mdia", mdhd, hdlr, minf)
    tkhd = _full(b"tkhd", 0, 7,
                 struct.pack(">IIIII", 0, 0, 1, 0, total_dur),
                 b"\x00" * 8,
                 struct.pack(">hhhH", 0, 0, 0, 0),
                 _matrix_identity(),
                 struct.pack(">II", w << 16, h << 16))
    trak = _box(b"trak", tkhd, mdia)
    mvhd = _full(b"mvhd", 0, 0,
                 struct.pack(">IIII", 0, 0, _TIMESCALE, total_dur),
                 struct.pack(">I", 0x00010000),  # rate 1.0
                 struct.pack(">H", 0x0100),      # volume
                 b"\x00" * 10,
                 _matrix_identity(),
                 b"\x00" * 24,
                 struct.pack(">I", 2))           # next_track_ID
    moov = _box(b"moov", mvhd, trak)

    with open(path, "wb") as fh:
        fh.write(ftyp)
        fh.write(mdat)
        fh.write(moov)
