"""Denoiser networks: the FiLM residual MLP, the phase-1 notebook MLP, the
transformer of the shadow route, and the flax-params converters (both
ways)."""

from ddqst_tpu_torch.models.convert import (  # noqa: F401
    chain_opt_from_flax,
    params_from_flax,
    params_to_flax,
)
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
