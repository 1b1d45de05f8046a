"""Denoiser networks: the FiLM residual MLP, the phase-1 notebook MLP, the
transformer of the shadow route, and the flax-params converter."""

from ddqst_tpu_torch.models.convert import params_from_flax  # noqa: F401
from ddqst_tpu_torch.models.d3pm import (  # noqa: F401
    ConditionalD3PM,
    FiLMResBlock,
    PlainMLP,
    build_model,
    init_params_,
)
from ddqst_tpu_torch.models.transformer import (  # noqa: F401
    TransformerDenoiser,
    basis_idx_to_labels,
    labels_to_basis_idx,
)
