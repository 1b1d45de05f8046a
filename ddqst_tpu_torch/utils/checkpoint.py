"""Params snapshots as ``torch.save`` state dicts.

The port's counterpart of ``save_params`` / ``restore_params`` in
``ddqst_tpu/utils/checkpoint.py``, and of the distillation Adam-state
snapshots (``_save_chain_opt`` / ``_load_chain_opt`` in
``ddqst_tpu/pipeline.py``). The orbax checkpoint manager (train state,
resume) is not ported yet (ROADMAP Queue 1 item 10).
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


def save_chain_opt(path: str, opt_state: dict) -> None:
    """Write a distillation Adam state (``train.finetune_chain``'s
    ``info['final_opt_state']``: ``{'count', 'mu', 'nu'}``, the moments
    keyed by parameter name) as a ``torch.save`` dict, atomically."""
    tmp = f"{path}.tmp"
    torch.save({
        "count": torch.as_tensor(opt_state["count"]).cpu(),
        "mu": {k: v.detach().cpu() for k, v in opt_state["mu"].items()},
        "nu": {k: v.detach().cpu() for k, v in opt_state["nu"].items()},
    }, tmp)
    os.replace(tmp, path)


def restore_chain_opt(path: str, template: dict) -> dict:
    """Load a distillation Adam state onto the device of ``template``
    (``train.chain_opt_template(model)``).

    Strict, as the params load is: moments whose names or shapes differ
    from the template's raise ``RuntimeError``.
    """
    tree = torch.load(path, map_location="cpu", weights_only=True)
    out = {"count": tree["count"]}
    for key in ("mu", "nu"):
        want, got = template[key], tree[key]
        if want.keys() != got.keys():
            raise RuntimeError(
                f"{path}: {key} names differ from the model's: "
                f"{sorted(want.keys() ^ got.keys())}")
        for name, ref in want.items():
            if got[name].shape != ref.shape:
                raise RuntimeError(
                    f"{path}: {key}[{name!r}] has shape "
                    f"{tuple(got[name].shape)}, expected {tuple(ref.shape)}")
        out[key] = {name: got[name].to(ref.device)
                    for name, ref in want.items()}
    return out
