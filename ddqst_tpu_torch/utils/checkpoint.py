"""Params snapshots as ``torch.save`` state dicts.

The port's counterpart of ``save_params`` / ``restore_params`` in
``ddqst_tpu/utils/checkpoint.py``. The orbax checkpoint manager (train
state, optimizer state, resume) is not ported yet (ROADMAP Queue 1 item
10).
"""

from __future__ import annotations

import os

import torch
from torch import nn


def save_params(path: str, model: nn.Module) -> None:
    """Write ``model``'s state dict (tensors moved to the CPU) atomically."""
    tmp = f"{path}.tmp"
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               tmp)
    os.replace(tmp, path)


def restore_params(path: str, model: nn.Module) -> nn.Module:
    """Load a snapshot into ``model`` (on the model's device) and return it.

    The load is strict: a snapshot whose tensors differ in name or shape
    from the model's (for instance a ``circuit_emb`` built for another
    circuit count) raises ``RuntimeError`` instead of giving a wrong model.
    """
    dev = next(model.parameters()).device
    model.load_state_dict(torch.load(path, map_location=dev, weights_only=True))
    return model
