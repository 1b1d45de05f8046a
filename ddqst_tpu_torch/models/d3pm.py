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

``build_model`` also builds ``models.transformer.TransformerDenoiser`` for
``arch='transformer'``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ddqst_tpu_torch.config import ModelConfig

# Std of a unit normal truncated to [-2, 2]: flax's truncated_normal rescale.
_TRUNC_STD = 0.87962566103423978


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

    def __init__(self, cond_dim: int, hidden_dim: int):
        super().__init__()
        self.film = nn.Linear(cond_dim, 2 * hidden_dim)
        self.fc1 = nn.Linear(hidden_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.film(cond).chunk(2, dim=-1)
        h = x * (1.0 + gamma) + beta
        h = self.fc2(F.silu(self.fc1(h)))
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
    ):
        super().__init__()
        self.num_qubits = num_qubits
        self.num_circuits = num_circuits
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
            FiLMResBlock(n_cond * embed_dim, hidden_dim)
            for _ in range(num_blocks)
        )
        self.output_head = nn.Linear(hidden_dim, num_qubits * 2)
        init_params_(self)

    def forward(
        self, x: torch.Tensor, t: torch.Tensor, basis_idx: torch.Tensor
    ) -> torch.Tensor:
        b = x.shape[0]
        circuit_idx = None
        if basis_idx.dim() == 2:
            basis_idx, circuit_idx = basis_idx[:, 0], basis_idx[:, 1]
        if self.input_encoding == "float":
            h = self.input_proj(x.float())
        else:
            emb = self.x_emb(x.long())  # [B, N, E]
            h = self.input_proj(emb.reshape(b, -1))
        parts = [self.time_emb(t.long()), self.basis_emb(basis_idx.long())]
        if self.num_circuits > 0:
            if circuit_idx is None:
                circuit_idx = torch.zeros_like(basis_idx)
            parts.append(self.circuit_emb(circuit_idx.long()))
        cond = torch.cat(parts, dim=-1)
        for block in self.blocks:
            h = block(h, cond)
        return self.output_head(h).reshape(b, self.num_qubits, 2).float()


def build_model(
    cfg: ModelConfig, num_qubits: int, num_timesteps: int,
    num_circuits: int = 0,
) -> nn.Module:
    """Instantiate a denoiser from a :class:`ModelConfig` (on the CPU; the
    caller moves it). ``num_circuits > 0`` adds the circuit embedding
    (``film_mlp`` only)."""
    if cfg.dtype != "float32":
        raise NotImplementedError(
            f"model dtype {cfg.dtype!r} is not ported; the port computes in "
            "float32"
        )
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
        )
    if cfg.arch != "film_mlp":
        raise NotImplementedError(
            f"arch={cfg.arch!r} is not ported yet (ROADMAP Queue 1 item 2: "
            "PlainMLP); 'film_mlp' and 'transformer' run"
        )
    return ConditionalD3PM(
        num_qubits=num_qubits,
        num_bases=3**num_qubits,
        num_timesteps=num_timesteps,
        embed_dim=cfg.embed_dim,
        hidden_dim=cfg.hidden_dim,
        num_blocks=cfg.num_blocks,
        input_encoding=cfg.input_encoding,
        num_circuits=num_circuits,
    )
