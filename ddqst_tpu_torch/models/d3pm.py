"""FiLM-conditioned residual-MLP denoiser (the reference's backbone family).

The port's counterpart of ``ddqst_tpu/models/d3pm.py``. Both input
encodings sit behind one ``input_encoding`` switch:

- ``"float"`` — bits cast to float and projected ``Linear(N -> H)``.
- ``"token"`` — per-bit embedding ``Embedding(2, E)`` flattened to
  ``[B, N·E]`` (each qubit's E values contiguous) then projected.

Conditioning: time embedding ``Embedding(T+1, E)`` and basis embedding
``Embedding(3^N, E)`` concatenated into a ``2E`` vector feeding one FiLM
layer per residual block: ``x * (1 + γ) + β`` (γ first, then β), then
Linear→SiLU→Linear with ``silu(x + h)`` as the block output. With
``num_circuits > 0`` a circuit embedding ``Embedding(C, E)`` joins as
``[t_emb, b_emb, circuit_emb]`` (a ``3E`` vector), for models trained on a
multi-circuit dataset: the conditioning input is then a packed ``[B, 2]``
of (basis, circuit), and a 1-D input takes circuit 0.

Parameters start from flax's default initialisers, so a model trained from
scratch starts from the same distribution as the JAX package's: Linear
weights lecun-normal (truncated normal, std sqrt(1/fan_in)/0.8796 cut at
±2 std) with zero bias, embeddings N(0, 1/E), LayerNorms at scale 1 and
bias 0, and the transformer's ``pos_emb`` N(0, 0.02).

``PlainMLP`` is the phase-1 notebook family (the ``notebook_*`` presets):
``concat(float bits, time emb, basis emb)``, then ``num_blocks`` x
[Linear, ReLU], then ``Linear(2N)``; no FiLM, no residuals.
``build_model`` also builds ``models.transformer.TransformerDenoiser`` for
``arch='transformer'``.

Compute dtype (``ModelConfig.dtype``): ``'float32'`` or ``'bfloat16'``. The
parameters and the optimiser state stay float32 and the logits come out
float32 in both; bfloat16 follows flax's ``dtype=`` semantics with explicit
casts in ``forward``, so the CPU and the card run the same arithmetic:
a ``Dense`` casts its input, kernel and bias to bfloat16 and computes in it
(:func:`dense`), an ``Embed`` returns its rows in bfloat16
(:func:`embed`), and a ``LayerNorm`` computes in float32 from its bfloat16
input and returns bfloat16 (``models.transformer.layer_norm``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ddqst_tpu_torch.config import ModelConfig
from ddqst_tpu_torch.ops import precision

# Std of a unit normal truncated to [-2, 2]: flax's truncated_normal rescale.
_TRUNC_STD = 0.87962566103423978

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` as a torch dtype; raises for any other name."""
    try:
        return _COMPUTE_DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown compute dtype {name!r}; options: "
                         f"{sorted(_COMPUTE_DTYPES)}") from None


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, kernel and bias cast to ``dtype``
    and the product computed in it. At float32 within
    ``ops.precision.default_matmul_precision("bfloat16")`` the product is
    the TPU's bf16-input pass (``ops.precision.linear``)."""
    if dtype == torch.float32 and precision.active():
        return precision.linear(x.float(), layer.weight, layer.bias)
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


# Tables of at most this many rows take their gradient as one one-hot
# product over every row; a larger table's product runs over the rows the
# indices name (``torch.unique``, which waits for the card once).
ONE_HOT_ROWS = 256
# Elements of one one-hot block: the product runs over blocks of the
# indices, each of at most this many one-hot elements, summed in order.
ONE_HOT_BLOCK_ELEMS = 1 << 24


def table_grad(idx: torch.Tensor, grad: torch.Tensor,
               rows: int) -> torch.Tensor:
    """The gradient ``[rows, E]`` of a row lookup, each row's sum in a fixed
    order: the one-hot ``[rows, M]`` product with the ``[M, E]`` output
    gradients, one matrix product a block of indices on one stream, the
    blocks summed in index order. ``nn.Embedding``'s CUDA backward adds the
    rows' gradients in an order that changes from run to run."""
    flat = idx.reshape(-1)
    g = grad.reshape(-1, grad.shape[-1])
    if rows <= ONE_HOT_ROWS:
        names, inv = None, flat
        k = rows
    else:
        names, inv = torch.unique(flat, sorted=True, return_inverse=True)
        k = names.shape[0]
    out = g.new_zeros(k, g.shape[1])
    ids = torch.arange(k, device=flat.device)
    block = max(1, ONE_HOT_BLOCK_ELEMS // max(k, 1))
    for lo in range(0, flat.shape[0], block):
        one_hot = (inv[None, lo:lo + block] == ids[:, None]).to(g.dtype)
        out.addmm_(one_hot, g[lo:lo + block])
    if names is None:
        return out
    # The named rows are distinct, so the copy is a plain scatter.
    return g.new_zeros(rows, g.shape[1]).index_copy_(0, names, out)


class _Lookup(torch.autograd.Function):
    """``F.embedding``'s forward with :func:`table_grad` as its backward."""

    @staticmethod
    def forward(ctx, weight: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.rows = weight.shape[0]
        return F.embedding(idx, weight)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        return table_grad(idx, grad, ctx.rows), None


def embed(table: nn.Embedding, idx: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """flax ``Embed(dtype=dtype)``: the rows, cast to ``dtype``. The lookup
    is ``nn.Embedding``'s, bit for bit; its backward (:func:`table_grad`)
    gives the same gradient on every run, so one seed trains one model."""
    return _Lookup.apply(table.weight, idx.long()).to(dtype)


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator | None = None) -> None:
    """Re-draw every parameter from flax's default initialisers, in place.

    ``generator`` lives on the parameters' device; None draws from torch's
    global generator (only the constructor does that, and ``train.fit``
    re-draws from its own generator). Every parameter is covered, so one
    generator state gives one model.
    """
    for m in module.modules():
        if isinstance(m, nn.Linear):
            std = math.sqrt(1.0 / m.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, std=math.sqrt(1.0 / m.embedding_dim),
                            generator=generator)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        pos = getattr(m, "pos_emb", None)
        if isinstance(pos, nn.Parameter):  # the transformer's positions
            nn.init.normal_(pos, std=0.02, generator=generator)


class FiLMResBlock(nn.Module):
    """Residual block with feature-wise linear modulation."""

    def __init__(self, cond_dim: int, hidden_dim: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.film = nn.Linear(cond_dim, 2 * hidden_dim)
        self.fc1 = nn.Linear(hidden_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        gamma, beta = dense(self.film, cond, dt).chunk(2, dim=-1)
        h = x * (1.0 + gamma) + beta
        h = dense(self.fc2, F.silu(dense(self.fc1, h, dt)), dt)
        return F.silu(x + h)


class ConditionalD3PM(nn.Module):
    """Basis- and time-conditioned bitstring denoiser.

    ``forward(x_t [B,N] int, t [B] int, basis_idx [B] or [B, 2] int) ->
    logits [B,N,2]`` float32; the ``[B, 2]`` form packs (basis, circuit)
    for a model built with ``num_circuits > 0``.
    """

    def __init__(
        self,
        num_qubits: int,
        num_bases: int,
        num_timesteps: int,
        embed_dim: int = 64,
        hidden_dim: int = 512,
        num_blocks: int = 4,
        input_encoding: str = "float",
        num_circuits: int = 0,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_qubits = num_qubits
        self.num_circuits = num_circuits
        self.compute_dtype = compute_dtype
        self.input_encoding = input_encoding
        if input_encoding == "float":
            self.input_proj = nn.Linear(num_qubits, hidden_dim)
        elif input_encoding == "token":
            self.x_emb = nn.Embedding(2, embed_dim)
            self.input_proj = nn.Linear(num_qubits * embed_dim, hidden_dim)
        else:
            raise ValueError(f"bad input_encoding {input_encoding!r}")
        self.time_emb = nn.Embedding(num_timesteps + 1, embed_dim)
        self.basis_emb = nn.Embedding(num_bases, embed_dim)
        n_cond = 2
        if num_circuits > 0:
            self.circuit_emb = nn.Embedding(num_circuits, embed_dim)
            n_cond = 3
        self.blocks = nn.ModuleList(
            FiLMResBlock(n_cond * embed_dim, hidden_dim, compute_dtype)
            for _ in range(num_blocks)
        )
        self.output_head = nn.Linear(hidden_dim, num_qubits * 2)
        init_params_(self)

    def forward(
        self, x: torch.Tensor, t: torch.Tensor, basis_idx: torch.Tensor
    ) -> torch.Tensor:
        b = x.shape[0]
        dt = self.compute_dtype
        circuit_idx = None
        if basis_idx.dim() == 2:
            basis_idx, circuit_idx = basis_idx[:, 0], basis_idx[:, 1]
        if self.input_encoding == "float":
            h = dense(self.input_proj, x.to(dt), dt)
        else:
            emb = embed(self.x_emb, x, dt)  # [B, N, E]
            h = dense(self.input_proj, emb.reshape(b, -1), dt)
        parts = [embed(self.time_emb, t, dt), embed(self.basis_emb, basis_idx, dt)]
        if self.num_circuits > 0:
            if circuit_idx is None:
                circuit_idx = torch.zeros_like(basis_idx)
            parts.append(embed(self.circuit_emb, circuit_idx, dt))
        cond = torch.cat(parts, dim=-1)
        for block in self.blocks:
            h = block(h, cond)
        return dense(self.output_head, h, dt).reshape(b, self.num_qubits,
                                                       2).float()


class PlainMLP(nn.Module):
    """The phase-1 notebook MLP family (``SimpleMLP`` / ``UpgradedMLP``).

    ``forward(x [B,N] int, t [B] int, basis_idx [B] int) -> logits [B,N,2]``
    float32: ``concat(float bits, time_emb, basis_emb)``, then
    ``num_blocks`` x [Linear(H), ReLU] (``fcs.i``, flax's ``fc_i``), then
    ``Linear(2N)``. A ``[B, 2]`` conditioning input is read as packed
    (basis, circuit) and its circuit column is ignored: the model takes no
    circuit embedding.
    """

    def __init__(
        self,
        num_qubits: int,
        num_bases: int,
        num_timesteps: int,
        embed_dim: int = 32,
        hidden_dim: int = 128,
        num_blocks: int = 2,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_qubits = num_qubits
        self.compute_dtype = compute_dtype
        self.time_emb = nn.Embedding(num_timesteps + 1, embed_dim)
        self.basis_emb = nn.Embedding(num_bases, embed_dim)
        widths = [num_qubits + 2 * embed_dim] + [hidden_dim] * num_blocks
        self.fcs = nn.ModuleList(nn.Linear(a, b)
                                 for a, b in zip(widths, widths[1:]))
        self.output_head = nn.Linear(widths[-1], num_qubits * 2)
        init_params_(self)

    def forward(
        self, x: torch.Tensor, t: torch.Tensor, basis_idx: torch.Tensor
    ) -> torch.Tensor:
        b = x.shape[0]
        dt = self.compute_dtype
        if basis_idx.dim() == 2:
            basis_idx = basis_idx[:, 0]
        h = torch.cat([x.to(dt), embed(self.time_emb, t, dt),
                       embed(self.basis_emb, basis_idx, dt)], dim=-1)
        for fc in self.fcs:
            h = torch.relu(dense(fc, h, dt))
        return dense(self.output_head, h, dt).reshape(b, self.num_qubits,
                                                       2).float()


def build_model(
    cfg: ModelConfig, num_qubits: int, num_timesteps: int,
    num_circuits: int = 0,
) -> nn.Module:
    """Instantiate a denoiser from a :class:`ModelConfig` (on the CPU; the
    caller moves it). ``num_circuits > 0`` adds the circuit embedding
    (``film_mlp`` only; the other archs raise ``ValueError``, as in the JAX
    package)."""
    dt = compute_dtype(cfg.dtype)
    if cfg.arch == "transformer":
        if num_circuits > 0:
            raise ValueError("the transformer takes no circuit conditioning")
        from ddqst_tpu_torch.models.transformer import TransformerDenoiser

        return TransformerDenoiser(
            num_qubits=num_qubits,
            num_timesteps=num_timesteps,
            embed_dim=cfg.embed_dim,
            hidden_dim=cfg.hidden_dim,
            num_blocks=cfg.num_blocks,
            num_heads=cfg.num_heads,
            compute_dtype=dt,
        )
    if cfg.arch == "plain_mlp":
        if num_circuits > 0:
            raise ValueError("plain_mlp does not support circuit conditioning")
        return PlainMLP(
            num_qubits=num_qubits,
            num_bases=3**num_qubits,
            num_timesteps=num_timesteps,
            embed_dim=cfg.embed_dim,
            hidden_dim=cfg.hidden_dim,
            num_blocks=cfg.num_blocks,
            compute_dtype=dt,
        )
    if cfg.arch != "film_mlp":
        raise ValueError(f"unknown arch {cfg.arch!r}")
    return ConditionalD3PM(
        num_qubits=num_qubits,
        num_bases=3**num_qubits,
        num_timesteps=num_timesteps,
        embed_dim=cfg.embed_dim,
        hidden_dim=cfg.hidden_dim,
        num_blocks=cfg.num_blocks,
        input_encoding=cfg.input_encoding,
        num_circuits=num_circuits,
        compute_dtype=dt,
    )
