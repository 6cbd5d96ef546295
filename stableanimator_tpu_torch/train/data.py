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

import collections
import concurrent.futures
import os
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

    def draw(self) -> tuple:
        """The random choices of one sample: (video, start, reference)."""
        with self._lock:
            video_idx = int(self.rng.integers(len(self.video_dirs)))
            r_start = self.rng.random()
            r_ref = self.rng.random()
        return video_idx, r_start, r_ref

    def sample(self, drawn: tuple) -> Dict[str, np.ndarray]:
        """Load one sample: the clip and reference that `drawn` (from
        `draw`) chose."""
        video_idx, r_start, r_ref = drawn
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

    def load(self, draws: Sequence[tuple], rows: Sequence[int] | None = None
             ) -> Dict[str, np.ndarray]:
        """The batch of `draws`, or of its `rows` only."""
        picked = draws if rows is None else [draws[i] for i in rows]
        samples = [self.sample(d) for d in picked]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class PrefetchLoader:
    """Prefetch: overlaps host-side PNG decode with device steps (the
    reference delegates this to torch DataLoader workers, --num_workers=8;
    command_train.sh:10). Batches are drawn in order in the caller's thread
    (`sampler.plan`) and loaded by a pool, so the k-th batch is the k-th
    draw whatever the threads do: every rank of a data-parallel run draws
    the same global batches and loads only its `rows` of each."""

    def __init__(self, sampler, batch_size: int, num_workers: int = 4,
                 prefetch: int = 4, rows: Sequence[int] | None = None):
        self._sampler = sampler
        self._batch_size = batch_size
        self._rows = rows
        self._prefetch = prefetch
        self._pool = concurrent.futures.ThreadPoolExecutor(max(1, num_workers))
        self._pending: collections.deque = collections.deque()
        self._fill()

    def _fill(self):
        while len(self._pending) < self._prefetch:
            bucket, draws = self._sampler.plan(self._batch_size)
            self._pending.append(self._pool.submit(bucket.load, draws, self._rows))

    def next(self):
        batch = self._pending.popleft().result()
        self._fill()
        return batch

    def close(self):
        for f in self._pending:
            f.cancel()
        self._pool.shutdown(wait=True, cancel_futures=True)


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

    def plan(self, batch_size: int) -> tuple:
        """(bucket, its draws) of the next batch."""
        bucket = self.buckets[int(self.rng.integers(len(self.buckets)))]
        return bucket, [bucket.draw() for _ in range(batch_size)]

    def batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        bucket, draws = self.plan(batch_size)
        return bucket.load(draws)
