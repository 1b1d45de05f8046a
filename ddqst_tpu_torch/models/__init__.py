"""Denoiser networks: the FiLM residual MLP and the flax-params converter."""

from ddqst_tpu_torch.models.convert import params_from_flax  # noqa: F401
from ddqst_tpu_torch.models.d3pm import (  # noqa: F401
    ConditionalD3PM,
    FiLMResBlock,
    build_model,
    init_params_,
)
