"""Model library: layers and the ported architectures (the dense
``tblock`` and hybrid families).

Plain functions over nested dicts of tensors, laid out as the JAX
package's parameter trees so one converts into the other leaf for leaf.
"""
from repro_torch.models.registry import get_model, ModelAPI  # noqa: F401
