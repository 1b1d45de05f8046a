"""Convert the JAX package's flax params into this port's state dict.

``params_np`` is the flax ``params`` tree with every leaf as a numpy array
(``jax.tree_util.tree_map(np.asarray, params)``), so this module needs no
JAX. A flax ``Dense`` kernel is ``[in, out]`` and becomes the transposed
``nn.Linear`` weight; ``Embed`` tables copy as they are.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _linear(prefix: str, p: Mapping) -> dict[str, torch.Tensor]:
    return {
        f"{prefix}.weight": torch.from_numpy(np.ascontiguousarray(np.asarray(p["kernel"]).T)),
        f"{prefix}.bias": torch.from_numpy(np.array(p["bias"])),
    }


def params_from_flax(params_np: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``ConditionalD3PM`` params -> ``ConditionalD3PM.state_dict()``."""
    sd: dict[str, torch.Tensor] = {}
    for name, p in params_np.items():
        if name in ("x_emb", "time_emb", "basis_emb", "circuit_emb"):
            sd[f"{name}.weight"] = torch.from_numpy(np.array(p["embedding"]))
        elif name in ("input_proj", "output_head"):
            sd.update(_linear(name, p))
        elif name.startswith("block_"):
            i = int(name.split("_")[1])
            for sub in ("film", "fc1", "fc2"):
                sd.update(_linear(f"blocks.{i}.{sub}", p[sub]))
        else:
            raise ValueError(f"unexpected flax param group {name!r}")
    return sd
