"""Quantum simulator for data generation: host-side circuits and channels,
device-side basis rotation, Born probabilities and shot sampling."""

from ddqst_tpu_torch.qsim import gates, measure, noise, states  # noqa: F401
