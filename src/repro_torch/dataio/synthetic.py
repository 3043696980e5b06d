"""Synthetic data generators standing in for the paper's datasets.

- LFW-like face images (13k 250x250 faces): procedural "face" images —
  skin-tone ellipse + eye/mouth blobs on textured background — enough
  structure for the toy face detector to latch onto.
- Kinetics-like video clips: moving-blob activity clips.
- LM token streams for training the assigned architectures.

Deterministic per index, so loaders can shard by range without
materializing datasets.
"""
from __future__ import annotations

import numpy as np


def synthetic_faces(n: int, size: int = 128, seed: int = 0) -> np.ndarray:
    """(n, size, size, 3) float32 in [0,1]."""
    out = np.empty((n, size, size, 3), np.float32)
    for i in range(n):
        out[i] = _one_face(size, np.random.default_rng(seed * 100003 + i))
    return out


def _one_face(size: int, rng) -> np.ndarray:
    img = rng.uniform(0.05, 0.35, (size, size, 3)).astype(np.float32)
    # background texture
    img += 0.1 * np.sin(np.linspace(0, rng.uniform(2, 8), size))[None, :, None]
    cy, cx = (rng.uniform(0.35, 0.65, 2) * size).astype(int)
    ry, rx = int(size * rng.uniform(0.18, 0.3)), int(size * rng.uniform(0.14, 0.24))
    ys, xs = np.mgrid[0:size, 0:size]
    ellipse = ((ys - cy) / max(ry, 1)) ** 2 + ((xs - cx) / max(rx, 1)) ** 2 <= 1
    skin = np.array([rng.uniform(0.55, 0.85), rng.uniform(0.4, 0.6),
                     rng.uniform(0.3, 0.45)], np.float32)
    img[ellipse] = skin * rng.uniform(0.9, 1.1)
    # eyes + mouth
    for dx in (-rx // 2, rx // 2):
        ey, ex = cy - ry // 3, cx + dx
        eye = (ys - ey) ** 2 + (xs - ex) ** 2 <= max(size // 40, 2) ** 2
        img[eye] = 0.08
    mouth = (np.abs(ys - (cy + ry // 2)) <= max(size // 60, 1)) & \
        (np.abs(xs - cx) <= rx // 2)
    img[mouth] = np.array([0.5, 0.15, 0.15], np.float32)
    return np.clip(img, 0, 1)


def synthetic_video(n_frames: int = 32, size=96, seed: int = 0) -> np.ndarray:
    """(T, H, W, 3) moving-blob 'activity' clip; ``size`` is H = W, or an
    (H, W) pair (a square size gives the same clip either way)."""
    h, w = (size, size) if np.ndim(size) == 0 else size
    extent = np.array([h, w])
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.1, 0.3, (h, w, 3)).astype(np.float32)
    out = np.empty((n_frames, h, w, 3), np.float32)
    pos = rng.uniform(0.2, 0.8, 2) * extent
    vel = rng.uniform(-3, 3, 2)
    color = rng.uniform(0.5, 1.0, 3).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    for t in range(n_frames):
        pos = pos + vel
        vel = np.where((pos < 8) | (pos > extent - 8), -vel, vel)
        pos = np.clip(pos, 8, extent - 8)
        blob = (ys - pos[0]) ** 2 + (xs - pos[1]) ** 2 <= (min(h, w) // 10) ** 2
        frame = base.copy()
        frame[blob] = color
        out[t] = frame
    return np.clip(out, 0, 1)


def lm_token_stream(batch: int, seq: int, vocab: int, step: int,
                    seed: int = 0) -> np.ndarray:
    """Deterministic pseudo-text: Zipfian ids with local n-gram structure
    (so loss decreases measurably when the model trains)."""
    rng = np.random.default_rng(seed * 1000003 + step)
    ranks = rng.zipf(1.3, size=(batch, seq)).astype(np.int64)
    toks = (ranks * 2654435761) % max(vocab - 2, 1) + 1
    # inject learnable bigram structure: every even position repeats a
    # deterministic function of the previous token
    toks[:, 1::2] = (toks[:, 0::2] * 31 + 7) % max(vocab - 2, 1) + 1
    return toks.astype(np.int32)
