"""K5, the RWKV6 WKV scan (``kernels/rwkv6_scan.py``), against its
roofline at the shapes launched: work by the frozen ``wkv_work``."""
from harness.roofline import share
from harness.work import wkv_work

PROBE = ("repro_torch.kernels.rwkv6_scan", "rwkv6_scan_cuda")


def shape(r, k, v, *a, **kw):
    B, T, H, K = r.shape
    return {"B": B, "T": T, "H": H, "K": K, "V": v.shape[-1],
            "itemsize": r.element_size()}


def _work(s):
    return (*wkv_work(s["B"], s["T"], s["H"], s["K"], s["V"],
                      s["itemsize"]), s["itemsize"])


def read(run):
    return share(run, "k5_roofline", _work)
