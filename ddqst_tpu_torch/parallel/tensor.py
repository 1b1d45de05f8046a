"""Megatron-style tensor parallelism for the transformer denoiser.

The port's form of ``_TP_RULES``, ``transformer_param_shardings``,
``shard_params`` and ``shard_state`` (``ddqst_tpu/parallel/mesh.py:113-178``).
Attention's q/k/v projections and the MLP's up-projection split their output
features over the mesh's ``model`` axis (column-parallel), the attention
output and the MLP's down-projection their input features (row-parallel), so
each sublayer needs one all-reduce: :func:`copy_to_model` before the
column-parallel layers (identity forward, all-reduce of the gradient
backward) and :func:`reduce_from_model` after the row-parallel ones
(all-reduce forward, identity backward). XLA inserts these from the
shardings alone; here ``models.transformer`` calls them.

In torch, Adam's moments live with the parameters, so JAX's ``shard_state``
is: build the optimiser after :func:`shard_params`. Its ``exp_avg`` and
``exp_avg_sq`` are then this rank's shards, as JAX's ``mu`` and ``nu`` are.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ddqst_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, gather, split

# (name suffix, the dimension split over 'model'). torch's nn.Linear weight
# is [out, in], the transpose of flax's [in, out] kernel, so every dimension
# of JAX's rules flips. q/k/v rows are head-major (models/transformer.py).
# JAX leaves the q/k/v biases replicated: its sharded product still adds the
# whole [H, D] bias to the heads each device holds. The port's
# column-parallel q/k/v compute only the local heads, so they take the
# local heads' part of the bias: the same values.
_TP_RULES = (
    ("attn.query.weight", 0),
    ("attn.key.weight", 0),
    ("attn.value.weight", 0),
    ("attn.query.bias", 0),
    ("attn.key.bias", 0),
    ("attn.value.bias", 0),
    ("attn.out.weight", 1),
    ("mlp1.weight", 0),
    ("mlp1.bias", 0),
    ("mlp2.weight", 1),
)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """The input of column-parallel layers: the same tensor forward, the sum
    of the model ranks' gradients backward."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The output of row-parallel layers: the sum of the model ranks'
    partial products forward, the gradient as it is backward."""
    return _ReduceFromModel.apply(x, group)


def transformer_param_shardings(model: nn.Module) -> dict[str, int | None]:
    """Parameter name -> the dimension split over ``model``, or None
    (replicated: embeddings, ``pos_emb``, LayerNorms, ``film``,
    ``output_head`` and the biases of ``out`` and ``mlp2``, added once after
    the reduce). A model of another arch matches no rule and stays
    replicated, as in JAX."""
    out = {}
    for name, _ in model.named_parameters():
        out[name] = next((dim for suffix, dim in _TP_RULES
                          if name.endswith(suffix)), None)
    return out


def _tp_blocks(model: nn.Module) -> list[nn.Module]:
    from ddqst_tpu_torch.models.transformer import TransformerBlock

    return [m for m in model.modules() if isinstance(m, TransformerBlock)]


def _replace(model: nn.Module, name: str, value: torch.Tensor) -> None:
    owner, _, attr = name.rpartition(".")
    module = model.get_submodule(owner)
    setattr(module, attr, nn.Parameter(value, requires_grad=getattr(
        module, attr).requires_grad))


def shard_params(mesh: Mesh, model: nn.Module) -> nn.Module:
    """Turn a ``TransformerDenoiser`` in place into its tensor-parallel form
    on this rank: local heads ``num_heads / model`` and local hidden
    ``hidden_dim / model``, its ruled parameters replaced by this rank's
    shards. Raises ``ValueError`` unless both divide by ``model`` (JAX's
    placement raises on an uneven split). A mesh with ``model == 1``, and a
    model of another arch, are left as they are. Build the optimiser after
    this call."""
    m = mesh.shape[MODEL_AXIS]
    blocks = _tp_blocks(model)
    if m == 1 or not blocks:
        return model
    for b in blocks:
        if b.attn.num_heads % m or b.mlp1.out_features % m:
            raise ValueError(
                f"{b.attn.num_heads} heads and hidden {b.mlp1.out_features} "
                f"must both divide by the model axis ({m})")
    j = mesh.coords[1]
    for name, dim in transformer_param_shardings(model).items():
        if dim is not None:
            p = model.get_parameter(name)
            _replace(model, name, split(p.detach(), dim, j, m).clone())
    for b in blocks:
        b.attn.num_heads //= m
        b.tp_group = b.attn.tp_group = mesh.model_group
    return model


def gather_params(mesh: Mesh, model: nn.Module) -> nn.Module:
    """The inverse of :func:`shard_params`, in place: the whole module, the
    same on every rank of the model axis."""
    if not _is_sharded(model):
        return model
    dims = transformer_param_shardings(model)
    for name, t in gathered_state_dict(mesh, model).items():
        if dims.get(name) is not None:
            _replace(model, name, t)
    m = mesh.shape[MODEL_AXIS]
    for b in _tp_blocks(model):
        b.attn.num_heads *= m
        b.tp_group = b.attn.tp_group = None
    return model


def _is_sharded(model: nn.Module) -> bool:
    blocks = _tp_blocks(model)
    return bool(blocks) and blocks[0].tp_group is not None


def gathered_state_dict(mesh: Mesh, model: nn.Module) -> dict:
    """The whole model's state dict from a sharded one (every model rank
    takes part; the module stays sharded)."""
    sd = model.state_dict()
    if not _is_sharded(model):
        return sd
    dims = transformer_param_shardings(model)
    return {k: (v if dims.get(k) is None else
                gather(v, dims[k], mesh.model_ranks, mesh.model_group))
            for k, v in sd.items()}


def _moments(model: nn.Module, opt_state: dict, fn) -> dict:
    """``opt_state`` (an optimiser's state dict over ``model.parameters()``)
    with ``fn(tensor, dim)`` applied to the moments of the sharded
    parameters."""
    dims = list(transformer_param_shardings(model).values())
    state = {}
    for i, st in opt_state["state"].items():
        dim = dims[int(i)]
        state[i] = {k: (fn(v, dim) if dim is not None and k != "step" else v)
                    for k, v in st.items()}
    return {**opt_state, "state": state}


def gathered_optimizer_state(mesh: Mesh, model: nn.Module,
                             opt_state: dict) -> dict:
    """The whole model's optimiser state dict from this rank's (every
    model rank takes part)."""
    if not _is_sharded(model):
        return opt_state
    return _moments(model, opt_state, lambda v, dim: gather(
        v, dim, mesh.model_ranks, mesh.model_group))


def sharded_optimizer_state(mesh: Mesh, model: nn.Module,
                            opt_state: dict) -> dict:
    """This rank's part of a whole model's optimiser state dict, for the
    sharded ``model``."""
    if not _is_sharded(model):
        return opt_state
    m, j = mesh.shape[MODEL_AXIS], mesh.coords[1]
    return _moments(model, opt_state,
                    lambda v, dim: split(v, dim, j, m).clone())
