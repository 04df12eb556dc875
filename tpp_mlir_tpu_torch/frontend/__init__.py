"""Frontends: importers from external model formats into the tensor IR."""

from .torch_import import import_torch, import_torch_fx

__all__ = ["import_torch", "import_torch_fx"]
