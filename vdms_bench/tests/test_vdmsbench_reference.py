"""The plain references against hand-made cases, and the model
references against the program's prefill and decode at a small size on
the CPU (the program is imported here, by the test, never by the
reference)."""
import dataclasses

import numpy as np
import pytest
import torch

import _paths  # noqa: F401
import reference
from harness import weights
from reference import common, image_ops
from reference.stamp import mask, stamp


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads while the test runs (restored after), so that
    the engine's threads and torch's do not crowd the test workers that
    share the host."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def test_resize_weights_up_and_down():
    np.testing.assert_allclose(image_ops.resize_weights(2, 4), [
        [1, 0], [0.75, 0.25], [0.25, 0.75], [0, 1]])
    np.testing.assert_allclose(image_ops.resize_weights(4, 2), [
        [3 / 7, 3 / 7, 1 / 7, 0], [0, 1 / 7, 3 / 7, 3 / 7]])
    np.testing.assert_allclose(image_ops.resize_weights(3, 3), np.eye(3))
    np.testing.assert_allclose(image_ops.resize_weights(4, 2, "nearest"), [
        [0, 1, 0, 0], [0, 0, 0, 1]])


def test_resize_of_a_batch_applies_both_axes():
    x = torch.arange(2 * 2 * 2 * 1, dtype=torch.float32).reshape(2, 2, 2, 1)
    y = image_ops.apply({"type": "resize", "width": 4, "height": 4}, x)
    w = torch.tensor(image_ops.resize_weights(2, 4), dtype=torch.float32)
    want = torch.einsum("oh,bhwc,pw->bopc", w, x, w)
    torch.testing.assert_close(y, want)


def test_crop_clamps_its_window_into_the_image():
    x = torch.arange(16.0).reshape(1, 4, 4, 1)
    y = image_ops.apply({"type": "crop", "x": 3, "y": 1, "width": 2,
                         "height": 2}, x)
    torch.testing.assert_close(y[0, :, :, 0], torch.tensor([[6., 7.],
                                                            [10., 11.]]))


def test_normalize():
    x = torch.full((1, 2, 2, 3), 0.67)
    y = image_ops.apply({"type": "normalize", "mean": 0.45, "std": 0.22}, x)
    torch.testing.assert_close(y, torch.ones_like(x))


def test_gaussian_taps_follow_opencv():
    taps = image_ops.gaussian_taps(3, 0.0)        # sigma 0.8 by OpenCV's rule
    w = np.exp(-np.array([1.0, 0.0, 1.0]) / (2 * 0.8 ** 2))
    np.testing.assert_allclose(taps, w / w.sum(), rtol=1e-6)


def test_blur_keeps_a_constant_and_spreads_a_point():
    flat = torch.full((1, 7, 7, 3), 0.3)
    torch.testing.assert_close(
        image_ops.apply({"type": "blur", "ksize": 5, "sigma_x": 1.0}, flat),
        flat)
    point = torch.zeros(1, 9, 9, 1)
    point[0, 4, 4, 0] = 1.0
    y = image_ops.apply({"type": "blur", "ksize": 3, "sigma_x": 1.0}, point)
    k = torch.tensor(image_ops.gaussian_taps(3, 1.0))
    torch.testing.assert_close(y[0, 3:6, 3:6, 0], torch.outer(k, k))
    # reflect-101 at the border: row -1 reads row 1, so a point on row 1
    # reaches row 0 twice and a point on row 0 is not repeated
    edge = torch.zeros(1, 5, 5, 1)
    edge[0, 1, 2, 0] = 1.0
    y = image_ops.apply({"type": "blur", "ksize": 3, "sigma_x": 1.0}, edge)
    assert float(y[0, 0, 2, 0]) == pytest.approx(float(2 * k[0] * k[1]))
    edge = torch.zeros(1, 5, 5, 1)
    edge[0, 0, 2, 0] = 1.0
    y = image_ops.apply({"type": "blur", "ksize": 3, "sigma_x": 1.0}, edge)
    assert float(y[0, 0, 2, 0]) == pytest.approx(float(k[1] * k[1]))


def test_prompt_truncates_and_reports_its_range():
    img = torch.full((2, 4, 4, 3), 0.5)
    img[1] = 0.9
    torch.testing.assert_close(image_ops.prompt(img, 1000),
                               torch.tensor([[127] * 3, [229] * 3]))
    # 0.2 * 255 = 51.0000..: a pixel this close to an integer may go either way
    near = torch.full((1, 1, 1, 3), 51.0 / 255.0)
    lo, hi = image_ops.prompt_range(near, 1000, 1e-3)
    assert lo.tolist() == [[50] * 3] and hi.tolist() == [[51] * 3]


def test_stamp_writes_the_letters_mask():
    assert mask("I")[:, 0].tolist() == [1, 0, 0, 0, 0, 0, 1]
    img = torch.zeros(10, 20, 3)
    out = stamp(img, "I", 1, 2)
    assert out[2, 1:6, 0].tolist() == [1, 1, 1, 1, 1]
    assert float(out[2, 6].sum()) == 0.0
    assert float(out.sum()) == 3 * float(mask("I").sum())


def test_tf32_rounds_to_ten_mantissa_bits_ties_to_even():
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, 1 + 2 ** -12,
                      -(1 + 3 * 2 ** -11), 3.0])
    torch.testing.assert_close(common.tf32_round(x), torch.tensor(
        [1.0, 1 + 2 ** -9, 1.0, -(1 + 2 ** -9), 3.0]), rtol=0, atol=0)


def _program_logits(arch, params, tokens, prompt_len):
    """The program's logits at each position from the last prompt token
    on: one prefill of the prompt, then one decode step a token."""
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.models import get_model
    from repro_torch.serving.serve_step import make_serve_fns
    prefill, step = make_serve_fns(get_model(arch), ShardingCtx(mesh=None))
    S = tokens.shape[1]
    with torch.no_grad():
        logits, cache = prefill(params, {"tokens": tokens[:, :prompt_len]},
                                S + 1)
        out = [logits]
        for i in range(prompt_len, S):
            logits, cache = step(params, tokens[:, i:i + 1], cache, i)
            out.append(logits)
    return torch.stack(out, 1)[..., :arch.vocab_size]


@pytest.mark.parametrize("name,module", [("rwkv6-1.6b", "rwkv6")])
def test_reference_forward_matches_the_program_at_a_small_size(name, module):
    from repro_torch.configs import get_arch
    arch = get_arch(name, reduced=True)
    cfg = dataclasses.asdict(arch)
    ref = reference.model(module)
    params = weights.make(ref.layout(cfg), 7, "cpu")
    tokens = torch.randint(0, arch.vocab_size, (3, 7),
                           generator=torch.Generator().manual_seed(0))
    got = _program_logits(arch, params, tokens, 3)
    with torch.no_grad():
        want = ref.forward(params, tokens, cfg)[:, 2:]
        low = ref.forward(params, tokens, cfg, "tf32")[:, 2:]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    # the control's precision moves the logits far more than the program's
    assert float((low - want).abs().max()) > 10 * float(
        (got - want).abs().max())
