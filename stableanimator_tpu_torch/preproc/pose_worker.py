"""Pose-extraction worker subprocess (port of the JAX package's
`preproc/pose_worker.py`).

DWPose extraction runs in a process of its own so that it overlaps the
caller's model build and kernel-build warm (the CLI's driving-video path)
without sharing the caller's interpreter lock or CUDA stream: the two
networks and the host-side NMS, crops and raster run in the worker while
the main process builds the diffusion models.

Protocol (line-delimited JSON over stdin/stdout):
  -> {"op": "init", "det": path, "pose": path, "device": "cuda" | "cpu",
      "letterbox": [w, h] | null, "max_det": int | null}
  <- {"ok": true}
  -> {"op": "extract", "frames_npy": in_path, "reference_npy": ref_path,
      "out_npy": out_path, "height": H, "width": W}
  <- {"ok": true, "seconds": t, "frames": F, "aligned": bool}
  -> {"op": "image_pose", "reference_npy": ref, "out_npy": out}
  <- {"ok": true, "seconds": t}
  -> {"op": "exit"}
  <- {"ok": true}

Arrays cross the boundary as .npy files, keeping the pipe protocol trivial.
Any error is reported as {"ok": false, "error": ...} on the request that
caused it; the worker keeps serving.

    python -m stableanimator_tpu_torch.preproc.pose_worker
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np


def _reply(stdout, **fields):
    print(json.dumps({"ok": True, **fields}), file=stdout, flush=True)


def serve(stdin=None, stdout=None):
    """Answer requests from `stdin` (default sys.stdin) on `stdout` until
    "exit" or the end of the input."""
    from stableanimator_tpu_torch.preproc.skeleton_extraction import (
        get_image_pose,
        get_video_pose,
    )
    from stableanimator_tpu_torch.preproc.skeleton_render import draw_pose
    from stableanimator_tpu_torch.preproc.wholebody import WholebodyDetector

    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    wb = None
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            op = req["op"]
            if op == "exit":
                _reply(stdout)
                return
            if op == "init":
                wb = WholebodyDetector(req["det"], req["pose"], max_det=req.get("max_det"),
                                       device=req["device"])
                if req.get("letterbox"):
                    wb.detector.input_size = tuple(req["letterbox"])
                _reply(stdout)
                continue
            if wb is None:
                raise RuntimeError("send init first")
            t0 = time.time()
            if op == "image_pose":
                ref = np.load(req["reference_npy"])
                np.save(req["out_npy"], get_image_pose(wb, ref))
                _reply(stdout, seconds=round(time.time() - t0, 3))
                continue
            if op == "extract":
                frames = np.load(req["frames_npy"])
                ref = np.load(req["reference_npy"])
                aligned = True
                try:
                    maps = get_video_pose(wb, list(frames), ref)
                except ValueError:
                    # no frame with exactly one 18-joint body to fit the
                    # alignment on: render unaligned
                    aligned = False
                    maps = np.stack([draw_pose(p, req["height"], req["width"])
                                     for p in wb.video_poses(list(frames))])
                np.save(req["out_npy"], maps)
                _reply(stdout, frames=int(maps.shape[0]), aligned=aligned,
                       seconds=round(time.time() - t0, 3))
                continue
            raise ValueError(f"unknown op {op!r}")
        except Exception as e:  # report, keep serving
            print(json.dumps({"ok": False, "error": f"{type(e).__name__}: {e}"}), file=stdout,
                  flush=True)


class PoseWorker:
    """Client handle: spawns the worker, ships requests, blocks on acks.

    The constructor returns at once; the worker's start (torch import, CUDA
    context, ONNX load) overlaps the caller's own work. Every call raises
    RuntimeError on a worker-reported error. `close()` ends the worker and
    removes the scratch directory it made."""

    def __init__(self, det_path: str, pose_path: str, letterbox=None, workdir: str | None = None,
                 device: str = "cuda", max_det: int | None = None):
        self._own_dir = workdir is None
        self._dir = workdir or tempfile.mkdtemp(prefix="pose_worker_")
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
        self._proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "stableanimator_tpu_torch.preproc.pose_worker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env, cwd=root)
        self.last_ack: dict = {}
        self._send({"op": "init", "det": det_path, "pose": pose_path, "device": str(device),
                    "letterbox": list(letterbox) if letterbox else None, "max_det": max_det})
        self._pending = ["init"]  # the ops whose acks are outstanding, in order

    def _send(self, req):
        self._proc.stdin.write(json.dumps(req) + "\n")
        self._proc.stdin.flush()

    def _recv(self):
        line = self._proc.stdout.readline()
        if not line:
            raise RuntimeError(f"pose worker died (rc={self._proc.poll()})")
        rec = json.loads(line)
        if not rec.get("ok"):
            raise RuntimeError(f"pose worker: {rec.get('error')}")
        self.last_ack = rec
        return rec

    def _drain(self):
        while self._pending:
            self._pending.pop(0)
            self._recv()

    def extract_async(self, frames, reference, height, width, tag="clip"):
        """Ship an extraction request; returns a join() callable producing
        (pose_maps [F,3,H,W] uint8, the worker's ack). The request may queue
        behind the init (its ack is read by join()), so the caller's own work
        overlaps the worker's start."""
        if self._pending != ["init"]:
            self._drain()
        fp = os.path.join(self._dir, f"{tag}_frames.npy")
        rp = os.path.join(self._dir, f"{tag}_ref.npy")
        op = os.path.join(self._dir, f"{tag}_poses.npy")
        np.save(fp, np.asarray(frames))
        np.save(rp, np.asarray(reference))
        self._send({"op": "extract", "frames_npy": fp, "reference_npy": rp, "out_npy": op,
                    "height": height, "width": width})
        self._pending.append("extract")

        def join():
            self._drain()
            return np.load(op), self.last_ack

        return join

    def image_pose(self, reference, tag="ref"):
        """The render of `reference`'s pose -> [3, H, W] uint8."""
        self._drain()
        rp = os.path.join(self._dir, f"{tag}_img.npy")
        op = os.path.join(self._dir, f"{tag}_pose.npy")
        np.save(rp, np.asarray(reference))
        self._send({"op": "image_pose", "reference_npy": rp, "out_npy": op})
        self._recv()
        return np.load(op)

    def close(self):
        try:
            self._send({"op": "exit"})
            self._proc.wait(timeout=60)
        except (OSError, subprocess.TimeoutExpired):
            self._proc.kill()
            self._proc.wait()
        finally:
            for stream in (self._proc.stdin, self._proc.stdout):
                stream.close()
            if self._own_dir:
                shutil.rmtree(self._dir, ignore_errors=True)


if __name__ == "__main__":
    serve()
