"""Convert the JAX package's flax params into this port's state dict.

``params_np`` is the flax ``params`` tree with every leaf as a numpy array
(``jax.tree_util.tree_map(np.asarray, params)``), so this module needs no
JAX. A flax ``Dense`` kernel is ``[in, out]`` and becomes the transposed
``nn.Linear`` weight; ``Embed`` tables copy as they are; a ``LayerNorm``'s
``scale`` becomes its ``weight``. The attention's ``DenseGeneral`` kernels
are flattened first: q/k/v ``[E, H, D]`` to ``[E, H·D]`` (bias ``[H, D]`` to
``[H·D]``) and ``out`` ``[H, D, E]`` to ``[H·D, E]``, head-major as
``models.transformer.SelfAttention`` reads them. ``params_to_flax`` undoes
each of these steps, so a model the port trained can run in the JAX
package.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _linear(prefix: str, p: Mapping, in_dims: int = 1) -> dict[str, torch.Tensor]:
    """A (Dense or DenseGeneral) kernel whose first ``in_dims`` axes are the
    inputs, as an ``nn.Linear``."""
    kernel = np.asarray(p["kernel"])
    kernel = kernel.reshape(int(np.prod(kernel.shape[:in_dims])), -1)
    return {
        f"{prefix}.weight": torch.from_numpy(np.ascontiguousarray(kernel.T)),
        f"{prefix}.bias": torch.from_numpy(np.array(p["bias"]).reshape(-1)),
    }


def _layer_norm(prefix: str, p: Mapping) -> dict[str, torch.Tensor]:
    return {
        f"{prefix}.weight": torch.from_numpy(np.array(p["scale"])),
        f"{prefix}.bias": torch.from_numpy(np.array(p["bias"])),
    }


def _transformer_block(prefix: str, p: Mapping) -> dict[str, torch.Tensor]:
    sd = {}
    for sub in ("film", "mlp1", "mlp2"):
        sd.update(_linear(f"{prefix}.{sub}", p[sub]))
    for sub in ("ln1", "ln2"):
        sd.update(_layer_norm(f"{prefix}.{sub}", p[sub]))
    for sub in ("query", "key", "value"):
        sd.update(_linear(f"{prefix}.attn.{sub}", p["attn"][sub]))
    sd.update(_linear(f"{prefix}.attn.out", p["attn"]["out"], in_dims=2))
    return sd


def params_from_flax(params_np: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``ConditionalD3PM``, ``PlainMLP`` or ``TransformerDenoiser``
    params -> the port's ``state_dict()`` of the same model (a PlainMLP's
    ``fc_i`` becomes ``fcs.i``)."""
    transformer = "pos_emb" in params_np
    sd: dict[str, torch.Tensor] = {}
    for name, p in params_np.items():
        if name in ("x_emb", "time_emb", "basis_emb", "circuit_emb",
                    "bit_emb"):
            sd[f"{name}.weight"] = torch.from_numpy(np.array(p["embedding"]))
        elif name == "pos_emb":
            sd[name] = torch.from_numpy(np.array(p))
        elif name in ("input_proj", "output_head"):
            sd.update(_linear(name, p))
        elif name.startswith("fc_"):
            sd.update(_linear(f"fcs.{int(name[3:])}", p))
        elif name == "ln_f":
            sd.update(_layer_norm(name, p))
        elif name.startswith("block_"):
            i = int(name.split("_")[1])
            if transformer:
                sd.update(_transformer_block(f"blocks.{i}", p))
            else:
                for sub in ("film", "fc1", "fc2"):
                    sd.update(_linear(f"blocks.{i}.{sub}", p[sub]))
        else:
            raise ValueError(f"unexpected flax param group {name!r}")
    return sd


_EMBEDS = ("x_emb", "time_emb", "basis_emb", "circuit_emb", "bit_emb")
_LAYER_NORMS = ("ln_f", "ln1", "ln2")
_ATTENTION_INPUTS = ("query", "key", "value")


def params_to_flax(state_dict: Mapping,
                   num_heads: int | None = None) -> dict:
    """The port's ``state_dict()`` -> the flax params tree of the same model,
    every leaf a numpy array: the inverse of :func:`params_from_flax`, so
    ``params_to_flax(params_from_flax(p))`` equals ``p`` leaf for leaf.
    Flax's ``apply`` takes it as ``{'params': tree}``. A transformer's
    attention kernels need ``num_heads`` to be split into heads again;
    ``ValueError`` without it."""
    tree: dict = {}
    for key, value in state_dict.items():
        a = value.detach().cpu().numpy()
        if key == "pos_emb":
            tree[key] = a
            continue
        *mod, leaf = key.split(".")
        if mod[0] == "fcs":
            mod = [f"fc_{mod[1]}"]
        elif mod[0] == "blocks":
            mod = [f"block_{mod[1]}", *mod[2:]]
        node = tree
        for m in mod:
            node = node.setdefault(m, {})
        name = mod[-1]
        if name in _EMBEDS:
            node["embedding"] = a
        elif name in _LAYER_NORMS:
            node["scale" if leaf == "weight" else "bias"] = a
        elif mod[-2:-1] == ["attn"]:
            if num_heads is None:
                raise ValueError(f"{key}: an attention kernel needs "
                                 "num_heads")
            if name in _ATTENTION_INPUTS:  # [H·D, E] -> kernel [E, H, D]
                node[{"weight": "kernel"}.get(leaf, leaf)] = (
                    np.ascontiguousarray(a.T).reshape(a.shape[1], num_heads,
                                                      -1)
                    if leaf == "weight" else a.reshape(num_heads, -1))
            elif leaf == "weight":  # out: [E, H·D] -> kernel [H, D, E]
                node["kernel"] = np.ascontiguousarray(a.T).reshape(
                    num_heads, -1, a.shape[0])
            else:
                node["bias"] = a
        elif leaf == "weight":
            node["kernel"] = np.ascontiguousarray(a.T)
        else:
            node["bias"] = a
    return tree


def chain_opt_from_flax(tree_np: Mapping) -> dict:
    """A distillation Adam state of the JAX package (``{'count', 'mu',
    'nu'}``, the moments flax params trees with numpy leaves, as
    ``ddqst_tpu/pipeline.py``'s ``_save_chain_opt`` writes it) -> the port's
    (``train.chain_opt_template``'s form: the moments keyed by parameter
    name). Each moment is laid out as its parameter is, by
    :func:`params_from_flax`."""
    return {"count": torch.from_numpy(np.array(tree_np["count"])),
            "mu": params_from_flax(tree_np["mu"]),
            "nu": params_from_flax(tree_np["nu"])}
