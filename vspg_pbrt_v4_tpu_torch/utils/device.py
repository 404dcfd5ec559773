"""Moving scene objects between devices.

Scene objects are small dataclasses of tensors. ``OnDevice.to`` returns a
copy with every tensor field (and every nested scene object, tuple, dict
and module) on the given device; other fields (resolutions, flags, Python
numbers) are kept.
"""

from __future__ import annotations

import copy
import dataclasses

import torch


def to_device(obj, device):
    """`obj` with every tensor it holds moved to `device`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, torch.nn.Module):
        return copy.deepcopy(obj).to(device)  # Module.to moves in place
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        items = [to_device(x, device) for x in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return obj


class OnDevice:
    """Mixin for scene dataclasses: ``obj.to(device)``."""

    def to(self, device):
        return to_device(self, device)
