"""An LFW-like face collection drawn on the device from the seed, in
batches: a textured background, a skin-toned ellipse, two dark eyes and
a mouth per image (the repository's synthetic faces, drawn in bulk).
Returned in host memory, where the engine's store keeps blobs."""
from __future__ import annotations

import torch

from harness.seeds import stream

CHUNK = 512


def _uniform(g, shape, lo, hi, device):
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def _chunk(n: int, size: int, g, device) -> torch.Tensor:
    S = size
    img = _uniform(g, (n, S, S, 3), 0.05, 0.35, device)
    freq = _uniform(g, (n, 1), 2.0, 8.0, device)
    ramp = torch.linspace(0.0, 1.0, S, device=device)[None, :]
    img += 0.1 * torch.sin(freq * ramp)[:, None, :, None]
    cy = torch.floor(_uniform(g, (n,), 0.35, 0.65, device) * S)
    cx = torch.floor(_uniform(g, (n,), 0.35, 0.65, device) * S)
    ry = torch.floor(S * _uniform(g, (n,), 0.18, 0.3, device)).clamp(min=1)
    rx = torch.floor(S * _uniform(g, (n,), 0.14, 0.24, device)).clamp(min=1)
    skin = (torch.stack([_uniform(g, (n,), 0.55, 0.85, device),
                         _uniform(g, (n,), 0.4, 0.6, device),
                         _uniform(g, (n,), 0.3, 0.45, device)], dim=1)
            * _uniform(g, (n, 1), 0.9, 1.1, device))
    ys = torch.arange(S, device=device, dtype=torch.float32)[None, :, None]
    xs = torch.arange(S, device=device, dtype=torch.float32)[None, None, :]

    def col(v):
        return v[:, None, None]

    ellipse = (((ys - col(cy)) / col(ry)) ** 2
               + ((xs - col(cx)) / col(rx)) ** 2) <= 1
    img = torch.where(ellipse[..., None], skin[:, None, None, :], img)
    eye_r2 = float(max(S // 40, 2) ** 2)
    ey = col(cy - torch.floor(ry / 3))
    for side in (-1, 1):
        ex = col(cx + side * torch.floor(rx / 2))
        eye = (ys - ey) ** 2 + (xs - ex) ** 2 <= eye_r2
        img = torch.where(eye[..., None], torch.full_like(img, 0.08), img)
    half = float(max(S // 60, 1))
    mouth = ((ys - col(cy + torch.floor(ry / 2))).abs() <= half) & (
        (xs - col(cx)).abs() <= col(torch.floor(rx / 2)))
    lips = torch.tensor([0.5, 0.15, 0.15], device=device)
    img = torch.where(mouth[..., None], lips, img)
    return img.clamp_(0.0, 1.0)


def faces(n: int, size: int, seed: int, device) -> torch.Tensor:
    """(n, size, size, 3) float32 faces in [0, 1] in host memory; chunk
    ``i`` of ``CHUNK`` faces is drawn from its own stream of ``seed``."""
    device = torch.device(device)
    out = torch.empty((n, size, size, 3), dtype=torch.float32)
    for i, lo in enumerate(range(0, n, CHUNK)):
        m = min(CHUNK, n - lo)
        g = torch.Generator(device=device)
        g.manual_seed(stream(seed, f"faces/{i}"))
        out[lo:lo + m].copy_(_chunk(m, size, g, device))
    return out
