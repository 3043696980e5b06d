"""K1, the separable Gaussian blur (``kernels/gaussian_blur.py``),
against its roofline at the shapes launched: work by the frozen
``blur_work``."""
from harness.roofline import share
from harness.work import blur_work

PROBE = ("repro_torch.kernels.ops", "gaussian_blur_cuda")


def shape(img, ksize, *a, **kw):
    n, h, w, c = img.shape
    return {"n": n, "h": h, "w": w, "c": c, "ksize": int(ksize)}


def _work(s):
    return (*blur_work(s["n"], s["h"], s["w"], s["c"], s["ksize"]), 4)


def read(run):
    return share(run, "k1_roofline", _work)
