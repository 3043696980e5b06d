from repro_torch.visual.ops import NATIVE_OPS, apply_native_op  # noqa: F401
