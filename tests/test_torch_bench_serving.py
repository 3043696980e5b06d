"""The port's serving bench (``benchmarks/torch_serving_bench.py``) on
the CPU: ``run``'s batched and sequential tokens equal each other and
the JAX package's greedy decoding from one JAX tree (reduced qwen3-0.6b,
``PRNGKey(0)``), and ``run_native_pool``'s pooled responses equal one
worker's."""
import numpy as np
import pytest


@pytest.fixture(scope="module")
def qwen():
    import jax
    from repro.configs import get_arch
    from repro.models import get_model
    cfg = get_arch("qwen3-0.6b", reduced=True)
    api = get_model(cfg)
    return cfg, api, api.init(jax.random.PRNGKey(0))


def test_batched_and_sequential_tokens_equal_the_reference(qwen):
    import jax.numpy as jnp
    from repro.distributed.sharding import REPLICATED
    from repro.serving import greedy_generate
    from benchmarks import torch_serving_bench as ts
    from repro_torch.configs import get_arch
    from repro_torch.interop import params_from_jax
    cfg, api, tree = qwen
    params = params_from_jax(tree, get_arch("qwen3-0.6b", reduced=True),
                             device="cpu")
    n, prompt_len, gen = 6, 8, 4
    (row,) = ts.run(n_requests=n, prompt_len=prompt_len, gen=gen,
                    group_size=4, device="cpu", params=params)
    assert row["name"] == "serving_grouped_batching"
    assert row["arch"] == "qwen3-0.6b-reduced" and row["groups_run"] == 2
    assert row["tokens_identical"]
    assert row["seq_tokens"] == row["batched_tokens"]
    rng = np.random.default_rng(0)           # the bench's prompts
    for got in row["seq_tokens"]:
        p = rng.integers(1, cfg.vocab_size, prompt_len)
        want = greedy_generate(
            api, tree, {"tokens": jnp.asarray(p)[None].astype(jnp.int32)},
            steps=gen, sh=REPLICATED)
        assert got == np.asarray(want)[0].tolist()
    assert ts.gates([row]) == []


def test_native_pool_responses_equal_one_workers():
    from benchmarks import torch_serving_bench as ts
    (row,) = ts.run_native_pool(n_images=4, size=64, sessions=2,
                                pool_workers=2, device="cpu")
    assert row["name"] == "native_pool_2w_vs_1w"
    assert row["responses_identical"]
    assert row["single_worker_s"] > 0 and row["pooled_s"] > 0
    assert ts.gates([row]) == []
