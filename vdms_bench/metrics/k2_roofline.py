"""K2, the fused resize, crop and normalize (``kernels/preprocess.py``),
against its roofline at the shapes launched: work by the frozen
``preprocess_work`` over the bands of the cropped resize matrices (the
reference's weights)."""
import numpy as np

from harness.roofline import share
from harness.work import preprocess_work
from reference.image_ops import resize_weights

PROBE = ("repro_torch.kernels.preprocess", "fused_resize_crop_normalize_cuda")


def shape(img, **kw):
    n, h, w, c = img.shape
    keep = ("resize_h", "resize_w", "method", "crop_x", "crop_y", "crop_w",
            "crop_h")
    return {"n": n, "h": h, "w": w, "c": c, **{k: kw[k] for k in keep
                                               if k in kw}}


def _band(m: np.ndarray) -> tuple[int, int]:
    """Widest band of nonzeros of a row, and the nonzeros."""
    nz = m != 0
    width = 1
    for row in nz:
        cols = np.flatnonzero(row)
        if cols.size:
            width = max(width, int(cols[-1] - cols[0] + 1))
    return width, int(nz.sum())


def _work(s):
    method = s.get("method", "bilinear")
    ch, cw = min(s["crop_h"], s["resize_h"]), min(s["crop_w"], s["resize_w"])
    cy = max(0, min(s["crop_y"], s["resize_h"] - ch))
    cx = max(0, min(s["crop_x"], s["resize_w"] - cw))
    ry = resize_weights(s["h"], s["resize_h"], method)[cy:cy + ch]
    rx = resize_weights(s["w"], s["resize_w"], method)[cx:cx + cw]
    py, nnz_y = _band(ry)
    px, nnz_x = _band(rx)
    return (*preprocess_work(s["n"], s["h"], s["w"], s["c"], ch, cw, py, px,
                             nnz_y, nnz_x), 4)


def read(run):
    return share(run, "k2_roofline", _work)
