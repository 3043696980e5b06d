"""The yardstick: the card's data-sheet peaks and the work each kernel
and each model step must do, counted for the function computed (the
bytes every input and output must move once, the operations it must
do), never for how a kernel does it.  A frozen copy of the program's
arithmetic at the time the benchmark was written, so that no later
change of the program moves the yardstick."""
from __future__ import annotations

# NVIDIA H100 SXM5 80GB data sheet, dense rates: HBM3 bytes/s; float32
# outside the tensor cores; matrix products on the tensor cores, float32
# kept at float32 accuracy as three TF32 passes (495/3 TF/s) and bfloat16
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
PRODUCT_FLOP_S = {4: 495e12 / 3, 2: 989e12}
# dense bfloat16: no route a later change may take runs faster
PEAK_FLOP_S = 989e12


def bound_s(nbytes: float, products: float, other: float, itemsize: int
            ) -> float:
    """Least seconds: the longest of the bytes at the HBM rate, the
    products at the tensor-core rate of the operands' width, and the
    other operations at the float32 rate."""
    return max(nbytes / HBM_BYTES_S, products / PRODUCT_FLOP_S[itemsize],
               other / FP32_FLOP_S)


def wkv_work(B, T, H, K, V, itemsize):
    """(bytes, products, other) of one WKV6 scan: r, k, v and y in their
    type, w, u and both states in float32, each once; per (batch, head)
    step the readout r·S and the update k vᵀ (4KV); other: the state's
    decay (KV) and the bonus (3K + 2V)."""
    nbytes = (3 * B * T * H * K + B * T * H * V) * itemsize \
        + (B * T * H * K + H * K + 2 * B * H * K * V) * 4
    steps = B * T * H
    return nbytes, 4 * K * V * steps, (K * V + 3 * K + 2 * V) * steps


def blur_work(n, h, w, c, ksize):
    """(bytes, products, other) of one separable blur of n images: read
    and written once in float32, a multiply and an add per tap in each
    of the two passes."""
    return 2 * n * h * w * c * 4, 0, 4 * ksize * n * h * w * c


def preprocess_work(n, h, w, c, hc, wc, py, px, nnz_y, nnz_x):
    """(bytes, products, other) of one fused resize, crop and normalize
    of n images h x w x c to hc x wc: images and output once in float32,
    the tap tables (a first index and ``py`` / ``px`` taps per output row
    and column); the two banded contractions over the cropped matrices'
    ``nnz_y`` and ``nnz_x`` nonzeros and the affine epilogue."""
    nbytes = (n * h * w * c + n * hc * wc * c
              + hc * (py + 1) + wc * (px + 1)) * 4
    other = 2 * n * c * (nnz_y * w + hc * nnz_x) + 2 * n * hc * wc * c
    return nbytes, 0, other
