"""The plain reference: straightforward PyTorch in float32 (TF32 off), no
kernels, no cache, no batching. It imports nothing of the port; each
configuration names its module here (``"reference"`` in its file)."""

import importlib


def load(name: str):
    """The reference module of a configuration: ``gpubench.reference.<name>``."""
    return importlib.import_module(f"gpubench.reference.{name}")
