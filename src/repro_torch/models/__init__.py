"""Model library: layers and the ported architectures (the dense, moe
and vlm ``tblock`` families, rwkv, the hybrid and the encoder-decoder).

Plain functions over nested dicts of tensors, laid out as the JAX
package's parameter trees so one converts into the other leaf for leaf.
"""
from repro_torch.models.registry import get_model, ModelAPI  # noqa: F401
