"""Toy face detector + the compound vision UDFs (Box/Mask/Manipulation,
ActivityRecognition).

The detector is a deliberately lightweight heuristic (skin-tone prior +
local-variance saliency, argmax over a coarse grid) — the paper treats
face detection as an opaque compute-intensive remote UDF, and what the
system cares about is its *cost and position in the pipeline*, not its
mAP.  The interface matches a real model server: image in, box out.

Every function takes (..., H, W, C): a single image or a stacked batch,
detected per image.
"""
from __future__ import annotations

import torch

from repro_torch.visual.font import draw_text
from repro_torch.visual.ops import resize_2d


def detect_face(img) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (cx, cy, r) of the most face-like region of each image
    (int32 tensors of the batch shape)."""
    H, W = img.shape[-3], img.shape[-2]
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    skin = (r > g) & (g > b * 0.8) & (r > 0.25) & (r < 0.95)
    gray = img.mean(dim=-1)
    # local variance via 2-level box downsampling
    coarse = resize_2d(gray, max(H // 8, 1), max(W // 8, 1), "linear")
    up = resize_2d(coarse, H, W, "linear")
    saliency = (gray - up).abs()
    score = saliency * (0.5 + 0.5 * skin.to(torch.float32))
    sc = resize_2d(score, max(H // 16, 1), max(W // 16, 1), "linear")
    idx = sc.flatten(-2).argmax(dim=-1)
    cy = (idx // sc.shape[-1]) * 16 + 8
    cx = (idx % sc.shape[-1]) * 16 + 8
    rad = torch.full_like(idx, min(H, W) // 4)
    return (cx.to(torch.int32), cy.to(torch.int32), rad.to(torch.int32))


def _per_image(*vals):
    """Lift per-image scalars to broadcast against (..., H, W)."""
    return tuple(v[..., None, None] for v in vals)


def _dyn_box(img, cx, cy, r, thickness=2):
    H, W = img.shape[-3], img.shape[-2]
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    cx, cy, r = _per_image(cx, cy, r)
    x0, y0 = cx - r, cy - r
    x1, y1 = cx + r, cy + r
    inside = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
    inner = ((ys >= y0 + thickness) & (ys < y1 - thickness)
             & (xs >= x0 + thickness) & (xs < x1 - thickness))
    border = inside & ~inner
    col = torch.tensor([0.0, 1.0, 0.0], dtype=img.dtype, device=img.device)
    return torch.where(border[..., None], col, img)


def _dyn_circle(img, cx, cy, r, keep_inside=True):
    H, W = img.shape[-3], img.shape[-2]
    ys = torch.arange(H, device=img.device)[:, None].to(torch.float32)
    xs = torch.arange(W, device=img.device)[None, :].to(torch.float32)
    cx, cy, r = _per_image(cx, cy, r)
    d2 = (ys - cy.to(torch.float32)) ** 2 + (xs - cx.to(torch.float32)) ** 2
    inside = d2 <= r.to(torch.float32) ** 2
    keep = inside if keep_inside else ~inside
    return torch.where(keep[..., None], img, 0.0).to(img.dtype)


# ------------------------------------------------------- compound UDFs
def facedetect_box(img, **_):
    """IQ4/VQ4: detect a face and draw a box around it."""
    cx, cy, r = detect_face(img)
    return _dyn_box(img, cx, cy, r)


def facedetect_mask(img, *, r: int | None = None, **_):
    """IQ5/VQ5: black circular mask of radius r over the face centre."""
    cx, cy, rr = detect_face(img)
    rad = torch.full_like(rr, r) if r is not None else rr
    return _dyn_circle(img, cx, cy, rad, keep_inside=False)


def facedetect_manipulation(img, **_):
    """IQ9/VQ9: keep only the face disk, black out everything else."""
    cx, cy, r = detect_face(img)
    return _dyn_circle(img, cx, cy, r, keep_inside=True)


def activity_recognition(img, *, labels=("WALK", "RUN", "JUMP", "SIT"), **_):
    """VQ8 stub classifier: coarse feature hash -> label, stamped on frame.
    A real model UDF can be registered instead via
    repro_torch.core.udf.register_udf.  The label is a host-side choice
    per image, so a batch is labelled image by image."""
    if img.ndim > 3:
        return torch.stack([activity_recognition(im, labels=labels)
                            for im in img])
    # population std, as jnp.std computes it
    feats = torch.stack([img.mean(), img.std(correction=0),
                         img[..., 0].mean(), img[..., 2].std(correction=0)])
    idx = int(((feats * 997).abs().sum() % len(labels)).to(torch.int32))
    return draw_text(img, labels[idx], 4, 4)
