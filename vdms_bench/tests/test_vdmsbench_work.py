"""The frozen yardstick against hand counts at small shapes."""
import pytest

import _paths  # noqa: F401
import reference
from harness import work


def test_wkv_work_by_hand():
    nbytes, products, other = work.wkv_work(1, 2, 3, 4, 4, 2)
    assert nbytes == (3 * 24 + 24) * 2 + (24 + 12 + 2 * 48) * 4
    assert products == 6 * 4 * 16
    assert other == 6 * (16 + 12 + 8)


def test_blur_and_preprocess_work_by_hand():
    assert work.blur_work(2, 3, 4, 3, 5) == (2 * 72 * 4, 0, 4 * 5 * 72)
    nbytes, _, other = work.preprocess_work(1, 4, 4, 1, 2, 2, 2, 2, 4, 4)
    assert nbytes == (16 + 4 + 2 * 3 + 2 * 3) * 4
    assert other == 2 * 1 * (4 * 4 + 2 * 4) + 2 * 4


def test_bound_is_the_longest_of_the_three_terms():
    assert work.bound_s(3.35e12, 0, 0, 4) == pytest.approx(1.0)
    assert work.bound_s(0, 989e12, 0, 2) == pytest.approx(1.0)
    assert work.bound_s(0, 0, 67e12, 4) == pytest.approx(1.0)




def test_model_products_count_each_weight_twice_a_token():
    r = {"d_model": 8, "num_layers": 1, "d_ff": 16, "rwkv_mix_lora": 2,
         "rwkv_decay_lora": 3, "rwkv_head_dim": 4, "vocab_size": 10}
    layer = 6 * 64 + 2 * 8 * 16 + 2 * 5 * 2 * 8 + 2 * 3 * 8
    want = 2 * 1 * 1 * layer + 2 * 8 * 10 + work.wkv_work(1, 1, 2, 4, 4, 4)[1]
    assert reference.model("rwkv6").products(r, 1, 1, 7, 1) == want
