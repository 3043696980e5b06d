"""Plain PyTorch references of what the benchmark's cells run: image
operations, the model UDF's label stamp, and float32 forwards of the
served models.  Nothing here imports the program under test."""
import importlib


def model(name: str):
    """The reference module of a configuration's ``"reference"`` key
    (``layout(cfg)`` and ``forward(params, tokens, cfg, precision)``)."""
    if not name.isidentifier():
        raise ValueError(f"no reference module {name!r}")
    return importlib.import_module(f"reference.{name}")
