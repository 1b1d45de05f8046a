#!/usr/bin/env python3
"""Convert a snapshot written by the JAX package into the PyTorch port's form.

    JAX_PLATFORMS=cpu python tools/flax_to_torch.py --kind params \\
        --src shadow_work/dist_seg_ce_params \\
        --out examples/reference_params/dist_seg_ce_params.pt

- ``--kind params``: a params snapshot (``ddqst_tpu.utils.checkpoint
  .save_params``, an orbax ``StandardCheckpointer`` directory), with or
  without a top-level ``params`` key, becomes the state dict that
  ``ddqst_tpu_torch.utils.checkpoint.restore_params`` loads strictly
  (``run_experiment(params_load=...)``).
- ``--kind chain_opt``: a distillation Adam state (``{'count', 'mu',
  'nu'}``, as ``ddqst_tpu/pipeline.py``'s ``opt_save`` writes it) becomes
  the file ``restore_chain_opt`` loads strictly (``opt_load=...``); each
  moment is laid out as its parameter is.
- ``--kind torch_params``, the other way: a state dict the port wrote
  (``--src MODEL.pt``) becomes an orbax params directory (``--out DIR``)
  that ``ddqst_tpu.utils.checkpoint.restore_params`` reads and
  ``ddqst_tpu.pipeline.run_experiment(params_load=...)`` starts from, so the
  JAX package can run the port's models. A transformer needs
  ``--num-heads``.

    JAX_PLATFORMS=cpu python tools/flax_to_torch.py --kind torch_params \\
        --src examples/reference_params/ghz6_auto_ce2_params.pt \\
        --out ladder_work/ghz6_auto_ce2_flax

Reading an orbax snapshot needs orbax and so JAX, which is why this script
lives outside both packages: it runs on the CPU, and its output is what the
port reads. The output is written atomically and is the same, byte for
byte, each time the same snapshot is converted to a file of the same name
with the same torch.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from ddqst_tpu.utils import checkpoint as jax_ckpt  # noqa: E402
from ddqst_tpu_torch.models import (  # noqa: E402
    chain_opt_from_flax, params_from_flax, params_to_flax)
from ddqst_tpu_torch.utils import checkpoint as torch_ckpt  # noqa: E402


def restore_numpy(src: str) -> dict:
    """The snapshot at ``src`` in its saved structure, every leaf a numpy
    array; raises ``ValueError`` for a leaf that is not float32 or an
    integer scalar (a bfloat16 leaf would need a cast the port does not
    make)."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  jax_ckpt.restore_params(src, None))
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        if leaf.dtype != np.float32 and not (
                leaf.ndim == 0 and np.issubdtype(leaf.dtype, np.integer)):
            raise ValueError(f"{src}: leaf {jax.tree_util.keystr(path)} is "
                             f"{leaf.dtype}{list(leaf.shape)}, expected "
                             "float32")
    return tree


def convert_params(src: str, out: str) -> dict:
    """Params snapshot ``src`` -> the port's state dict at ``out``."""
    tree = restore_numpy(src)
    sd = params_from_flax(tree.get("params", tree))
    torch_ckpt.save_state_dict(out, sd)
    return sd


def convert_chain_opt(src: str, out: str) -> dict:
    """Distillation Adam snapshot ``src`` -> the port's form at ``out``."""
    opt = chain_opt_from_flax(restore_numpy(src))
    torch_ckpt.save_chain_opt(out, opt)
    return opt


def convert_torch_params(src: str, out: str,
                         num_heads: int | None = None) -> dict:
    """The port's state dict at ``src`` -> a flax params snapshot at
    ``out`` (the tree ``params_to_flax`` gives, without a ``params`` key,
    as ``ddqst_tpu.utils.checkpoint.save_params`` writes one)."""
    import torch

    tree = params_to_flax(torch.load(src, map_location="cpu",
                                     weights_only=True), num_heads)
    jax_ckpt.save_params(out, tree)
    return tree


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kind", choices=("params", "chain_opt", "torch_params"),
                    required=True)
    ap.add_argument("--src", required=True,
                    help="the JAX package's snapshot directory (with "
                    "torch_params: the port's .pt file)")
    ap.add_argument("--out", required=True, help="the torch file to write "
                    "(with torch_params: the snapshot directory)")
    ap.add_argument("--num-heads", type=int, default=None,
                    help="torch_params of a transformer: its heads")
    args = ap.parse_args(argv)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    if args.kind == "torch_params":
        tree = convert_torch_params(args.src, args.out, args.num_heads)
        leaves = jax.tree_util.tree_leaves(tree)
        print(f"{args.src} -> {args.out}: {len(leaves)} arrays, "
              f"{sum(a.size for a in leaves)} elements")
        return 0
    if args.kind == "params":
        sd = convert_params(args.src, args.out)
    else:
        sd = convert_chain_opt(args.src, args.out)["mu"]
    print(f"{args.src} -> {args.out}: {len(sd)} tensors, "
          f"{sum(v.numel() for v in sd.values())} elements"
          + (" a moment" if args.kind == "chain_opt" else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
