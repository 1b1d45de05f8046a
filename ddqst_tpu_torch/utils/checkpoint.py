"""Training checkpoints and params snapshots as ``torch.save`` files.

The port's counterpart of ``ddqst_tpu/utils/checkpoint.py``:

- ``save_checkpoint`` / ``latest_step`` / ``restore_checkpoint`` — the
  training state (a dict: ``train.fit`` saves the model's state dict, the
  optimiser's, the optimiser step count and its ``torch.Generator``'s state)
  under ``ckpt_dir/<step>/checkpoint.pt``, written atomically (a temporary
  directory, then a rename), the 3 newest kept, as the orbax manager's
  ``max_to_keep=3`` keeps them, and a step at or below the newest kept one
  not written again (orbax's ``should_save``);
- ``save_params`` / ``restore_params`` — strict params snapshots
  (``save_state_dict`` writes one from a state dict, as
  ``tools/flax_to_torch.py`` does for the JAX package's snapshots);
- ``save_chain_opt`` / ``restore_chain_opt`` — the distillation Adam state
  (``_save_chain_opt`` / ``_load_chain_opt`` in ``ddqst_tpu/pipeline.py``).
"""

from __future__ import annotations

import os
import shutil

import torch
from torch import nn

_MAX_TO_KEEP = 3
_CKPT_FILE = "checkpoint.pt"


def _steps(ckpt_dir: str) -> list[int]:
    """The complete checkpoints' steps under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if d.isdigit() and os.path.exists(
                      os.path.join(ckpt_dir, d, _CKPT_FILE)))


def latest_step(ckpt_dir: str) -> int | None:
    """The newest checkpoint's step, or None when there is none."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def save_checkpoint(ckpt_dir: str, state: dict, step: int) -> bool:
    """Write ``state`` (a dict of tensors, state dicts and ints) as the
    checkpoint of ``step``, then delete all but the 3 newest. Returns False,
    writing nothing, when a checkpoint at ``step`` or later exists."""
    last = latest_step(ckpt_dir)
    if last is not None and last >= step:
        return False
    final = os.path.join(ckpt_dir, str(step))
    tmp = f"{final}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, _CKPT_FILE))
    os.replace(tmp, final)
    for old in _steps(ckpt_dir)[:-_MAX_TO_KEEP]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)))
    return True


def restore_checkpoint(ckpt_dir: str,
                       step: int | None = None) -> tuple[dict, int]:
    """Load the checkpoint of ``step`` (default: the newest) onto the CPU
    (``load_state_dict`` moves each part to its model's or optimiser's
    device). Returns ``(state, step)``; raises ``FileNotFoundError`` when
    there is none."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    state = torch.load(os.path.join(ckpt_dir, str(step), _CKPT_FILE),
                       map_location="cpu", weights_only=True)
    return state, step


def save_params(path: str, model: nn.Module) -> None:
    """Write ``model``'s state dict (tensors moved to the CPU) atomically."""
    save_state_dict(path, model.state_dict())


def save_state_dict(path: str, state_dict: dict) -> None:
    """Write a state dict (tensors moved to the CPU) atomically, in the
    form :func:`restore_params` reads."""
    tmp = f"{path}.tmp"
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
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
