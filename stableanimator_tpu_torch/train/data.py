"""Training data pipeline (port of the JAX package's `train/data.py`;
numpy and PIL only, so the same seed yields the same arrays).

Dataset layout is the reference's training contract (README.md:209-275 +
command_train.sh): a root folder of video directories, each holding
`images/`, `faces/` (binary face masks) and `poses/` frame PNGs, with two
path-list text files selecting the rectangular- and vertical-resolution
subsets (video_rec_path.txt / video_vec_path.txt).

Host-side numpy loader: samples a contiguous `sample_n_frames` window plus
a random reference frame per video, loads the matching masks and pose
renderings, and (optionally) computes/caches the ArcFace identity
embedding of the reference frame. Batches are channels-last float32
numpy arrays.
"""

from __future__ import annotations

import os
import queue
import re
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image


def _frames_in(folder: str) -> List[str]:
    def key(name):
        m = re.findall(r"\d+", name)
        return int(m[-1]) if m else 0

    return [os.path.join(folder, f) for f in
            sorted(os.listdir(folder), key=key) if f.endswith(".png")]


def read_path_list(path: str) -> List[str]:
    with open(path) as fh:
        return [line.strip() for line in fh if line.strip()]


class AnimationDataset:
    """One resolution bucket (rec or vec)."""

    def __init__(self, video_dirs: Sequence[str], sample_n_frames: int = 16,
                 width: int = 512, height: int = 512,
                 face_model=None, seed: int = 0):
        self.video_dirs = [d for d in video_dirs
                           if os.path.isdir(os.path.join(d, "images"))]
        if not self.video_dirs:
            raise ValueError("no valid video directories (need images/ subdirs)")
        self.sample_n_frames = sample_n_frames
        self.width = width
        self.height = height
        self.face_model = face_model
        self.rng = np.random.default_rng(seed)
        self._embed_cache: Dict[str, np.ndarray] = {}
        # rng draws are guarded so PrefetchLoader workers stay independent
        self._lock = threading.Lock()

    def _load_image(self, path: str, mode: str = "RGB") -> np.ndarray:
        img = Image.open(path).convert(mode).resize((self.width, self.height))
        return np.asarray(img, np.float32)

    def _face_embed(self, video_dir: str, ref_path: str) -> np.ndarray:
        cache_path = os.path.join(video_dir, "face_embed.npy")
        if video_dir in self._embed_cache:
            return self._embed_cache[video_dir]
        if os.path.exists(cache_path):
            emb = np.load(cache_path).astype(np.float32)
        elif self.face_model is not None:
            img = np.asarray(Image.open(ref_path).convert("RGB"))
            emb = self.face_model.get_id_embedding(img)
            emb = np.zeros((512,), np.float32) if emb is None else emb.astype(np.float32)
            np.save(cache_path, emb)
        else:
            emb = np.zeros((512,), np.float32)
        self._embed_cache[video_dir] = emb
        return emb

    def sample(self) -> Dict[str, np.ndarray]:
        with self._lock:
            video_idx = int(self.rng.integers(len(self.video_dirs)))
            r_start = self.rng.random()
            r_ref = self.rng.random()
        video_dir = self.video_dirs[video_idx]
        images = _frames_in(os.path.join(video_dir, "images"))
        poses = _frames_in(os.path.join(video_dir, "poses"))
        faces = _frames_in(os.path.join(video_dir, "faces"))
        n = min(len(images), len(poses), len(faces))
        if n < self.sample_n_frames:
            raise ValueError(f"{video_dir}: only {n} complete frames, "
                             f"need {self.sample_n_frames}")
        start = int(r_start * (n - self.sample_n_frames + 1))
        sel = range(start, start + self.sample_n_frames)
        ref_idx = int(r_ref * n)

        frames = np.stack([self._load_image(images[i]) for i in sel]) / 127.5 - 1.0
        pose_px = np.stack([self._load_image(poses[i]) for i in sel]) / 127.5 - 1.0
        masks = np.stack([self._load_image(faces[i], mode="L") for i in sel])
        masks = (masks > 127).astype(np.float32)[..., None]
        ref = self._load_image(images[ref_idx]) / 255.0
        return {
            "frames": frames.astype(np.float32),
            "ref_image": ref.astype(np.float32),
            "pose_pixels": pose_px.astype(np.float32),
            "face_embed": self._face_embed(video_dir, images[ref_idx]),
            "face_mask": masks,
        }

    def batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        samples = [self.sample() for _ in range(batch_size)]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class PrefetchLoader:
    """Threaded prefetch: overlaps host-side PNG decode/augment with device
    steps (the reference delegates this to torch DataLoader workers,
    --num_workers=8; command_train.sh:10)."""

    def __init__(self, sampler, batch_size: int, num_workers: int = 4,
                 prefetch: int = 4):
        self._sampler = sampler
        self._batch_size = batch_size
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(num_workers)
        ]
        for t in self._threads:
            t.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                batch = self._sampler.batch(self._batch_size)
            except Exception as e:  # surface loader errors to the consumer
                batch = e
            self._queue.put(batch)
            if isinstance(batch, Exception):
                return

    def next(self):
        item = self._queue.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        while not self._queue.empty():
            self._queue.get_nowait()


class MixedResolutionSampler:
    """Alternates between the rec (square) and vec (vertical) buckets, as
    the reference's mixed-resolution training does (README.md:285-350).
    Each batch is single-bucket, so its frames share one shape."""

    def __init__(self, rec: Optional[AnimationDataset],
                 vec: Optional[AnimationDataset], seed: int = 0):
        self.buckets = [b for b in (rec, vec) if b is not None]
        if not self.buckets:
            raise ValueError("need at least one dataset bucket")
        self.rng = np.random.default_rng(seed)

    def batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        bucket = self.buckets[int(self.rng.integers(len(self.buckets)))]
        return bucket.batch(batch_size)
