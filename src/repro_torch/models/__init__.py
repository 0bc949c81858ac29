"""The paper's CNNs as pure functions on tensors, and the ModelBundle API."""
from repro_torch.models.registry import ModelBundle, make_bundle

__all__ = ["ModelBundle", "make_bundle"]
