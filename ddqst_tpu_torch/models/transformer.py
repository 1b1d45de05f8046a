"""Transformer denoiser for the shadow route (large N, sampled bases).

The port's counterpart of ``ddqst_tpu/models/transformer.py``. The N-qubit
bitstring is a length-N token sequence conditioned per qubit: each token is
a bit embedding ``Embedding(2, E)`` plus a basis-character embedding
``Embedding(3, E)`` (0 = X, 1 = Y, 2 = Z) plus a learned position
``pos_emb [N, E]``, so the parameter count does not grow with 3^N. The
timestep enters every block through FiLM: ``film`` (``Linear(E -> 2E)`` of
the time embedding) modulates the first LayerNorm's output as
``x * (1 + γ) + β``, broadcast over the tokens.

Numerics follow flax, so converted weights give the same logits:

- LayerNorm with epsilon 1e-6 (torch's default is 1e-5);
- multi-head self-attention with the query scaled by ``1/sqrt(head_dim)``
  before the QK product and a float32 softmax, written as plain matrix
  products (N tokens is a short sequence, and the JAX package computes it
  with XLA, not a kernel). The q/k/v projections are ``Linear(E, E)`` whose
  output is laid out head-major (flax's ``[E, H, D]`` kernel flattened), and
  ``out`` is ``Linear(E, E)`` over the same layout (flax's ``[H, D, E]``);
- parameters start from flax's initialisers (``d3pm.init_params_``), with
  ``pos_emb`` from N(0, 0.02) and LayerNorms at scale 1, bias 0.

In bfloat16 (``compute_dtype``) the Dense and Embed layers follow
``d3pm.dense`` / ``d3pm.embed``, ``pos_emb`` is cast, a LayerNorm computes
in float32 and returns bfloat16 (flax's float32 statistics), the query is
divided by ``sqrt(head_dim)`` rounded to bfloat16, and the softmax takes and
returns bfloat16 (flax's attention with its default
``force_fp32_for_softmax=False``); the head's output is cast to float32.

Under tensor parallelism (``parallel.tensor.shard_params``) a block holds
its ``tp_group``: q/k/v and ``mlp1`` compute this rank's heads and hidden
units from ``copy_to_model`` of their input, and ``out`` and ``mlp2`` sum
their partial products over the group (``reduce_from_model``) before adding
their biases once. Without a group the arithmetic is the one above.

``ops.precision``'s emulation of the TPU's bf16-input products does not
cover attention, so within ``default_matmul_precision("bfloat16")`` the
forward raises ``ValueError``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ddqst_tpu_torch.models.d3pm import dense, embed, init_params_
from ddqst_tpu_torch.ops import precision
from ddqst_tpu_torch.parallel.tensor import copy_to_model, reduce_from_model

_LN_EPS = 1e-6  # flax.linen.LayerNorm's epsilon


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """flax ``LayerNorm(dtype=dtype)``: statistics and normalisation in
    float32, the result in ``dtype``."""
    return ln(x.float()).to(dtype)


def column_input(x: torch.Tensor, group) -> torch.Tensor:
    """The input of column-parallel layers (itself without a group)."""
    return x if group is None else copy_to_model(x, group)


def row_parallel(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
                 group) -> torch.Tensor:
    """``dense(layer, x)`` for a layer whose input features are split over
    ``group``: the partial products summed over it, then the bias once."""
    if group is None:
        return dense(layer, x, dtype)
    y = reduce_from_model(F.linear(x.to(dtype), layer.weight.to(dtype)), group)
    return y + layer.bias.to(dtype)


def basis_idx_to_labels(basis_idx: torch.Tensor, num_qubits: int) -> torch.Tensor:
    """Global basis index -> per-qubit labels ``[..., N]`` (0=X, 1=Y, 2=Z).

    Inverts the canonical ``itertools.product`` enumeration of
    ``ops.pauli.all_basis_labels``: qubit 0 is the most-significant base-3
    digit.
    """
    powers = 3 ** torch.arange(num_qubits - 1, -1, -1, device=basis_idx.device,
                               dtype=basis_idx.dtype)
    return (basis_idx[..., None] // powers) % 3


def labels_to_basis_idx(labels: torch.Tensor) -> torch.Tensor:
    n = labels.shape[-1]
    powers = 3 ** torch.arange(n - 1, -1, -1, device=labels.device,
                               dtype=labels.dtype)
    return (labels * powers).sum(-1)


class SelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` on one sequence (q = k = v)."""

    def __init__(self, embed_dim: int, num_heads: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads  # this rank's heads under TP
        self.head_dim = embed_dim // num_heads
        self.compute_dtype = compute_dtype
        self.tp_group = None
        self.query = nn.Linear(embed_dim, embed_dim)
        self.key = nn.Linear(embed_dim, embed_dim)
        self.value = nn.Linear(embed_dim, embed_dim)
        self.out = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, length, _ = x.shape
        h, d = self.num_heads, self.head_dim
        dt = self.compute_dtype
        x = column_input(x, self.tp_group)
        q = dense(self.query, x, dt).view(b, length, h, d) / torch.tensor(
            math.sqrt(d), dtype=dt)
        k = dense(self.key, x, dt).view(b, length, h, d)
        v = dense(self.value, x, dt).view(b, length, h, d)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, length, h * d)
        return row_parallel(self.out, o, dt, self.tp_group)


class TransformerBlock(nn.Module):
    def __init__(self, embed_dim: int, hidden_dim: int, num_heads: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.tp_group = None
        self.film = nn.Linear(embed_dim, 2 * embed_dim)
        self.ln1 = nn.LayerNorm(embed_dim, eps=_LN_EPS)
        self.attn = SelfAttention(embed_dim, num_heads, compute_dtype)
        self.ln2 = nn.LayerNorm(embed_dim, eps=_LN_EPS)
        self.mlp1 = nn.Linear(embed_dim, hidden_dim)
        self.mlp2 = nn.Linear(hidden_dim, embed_dim)

    def forward(self, h: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        gamma, beta = dense(self.film, cond, dt).chunk(2, dim=-1)
        x = (layer_norm(self.ln1, h, dt) * (1.0 + gamma[:, None, :])
             + beta[:, None, :])
        h = h + self.attn(x)
        x = column_input(layer_norm(self.ln2, h, dt), self.tp_group)
        y = row_parallel(self.mlp2, F.silu(dense(self.mlp1, x, dt)), dt,
                         self.tp_group)
        return h + y


class TransformerDenoiser(nn.Module):
    """``forward(x [B,N], t [B], basis [B] or [B,N]) -> logits [B,N,2]``.

    ``basis`` is a global basis index (converted to labels; valid while 3^N
    fits the index type) or per-qubit labels ``[B, N]``, the native form of
    the shadow route's sampled bases.
    """

    def __init__(
        self,
        num_qubits: int,
        num_timesteps: int,
        embed_dim: int = 128,
        hidden_dim: int = 512,
        num_blocks: int = 4,
        num_heads: int = 4,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_qubits = num_qubits
        self.compute_dtype = compute_dtype
        self.bit_emb = nn.Embedding(2, embed_dim)
        self.basis_emb = nn.Embedding(3, embed_dim)
        self.pos_emb = nn.Parameter(torch.empty(num_qubits, embed_dim))
        self.time_emb = nn.Embedding(num_timesteps + 1, embed_dim)
        self.blocks = nn.ModuleList(
            TransformerBlock(embed_dim, hidden_dim, num_heads, compute_dtype)
            for _ in range(num_blocks)
        )
        self.ln_f = nn.LayerNorm(embed_dim, eps=_LN_EPS)
        self.output_head = nn.Linear(embed_dim, 2)
        init_params_(self)

    def forward(
        self, x: torch.Tensor, t: torch.Tensor, basis: torch.Tensor
    ) -> torch.Tensor:
        precision.refuse("the transformer")
        dt = self.compute_dtype
        basis = basis.long()
        if basis.dim() == x.dim() - 1:
            basis = basis_idx_to_labels(basis, self.num_qubits)
        h = (embed(self.bit_emb, x, dt) + embed(self.basis_emb, basis, dt)
             + self.pos_emb.to(dt))
        cond = embed(self.time_emb, t, dt)
        for block in self.blocks:
            h = block(h, cond)
        return dense(self.output_head, layer_norm(self.ln_f, h, dt), dt).float()
