"""Outcome histograms for the estimators.

Only ``bits_to_counts`` of ``ddqst_tpu/ops/mle.py`` is ported so far; the
maximum-likelihood estimators (dense, factored and blocked RρR with the
readout POVM) are ROADMAP Queue 1 item 5, and ``reconstruction='mle'``
raises ``NotImplementedError`` in the pipeline.
"""

from __future__ import annotations

import torch


def bits_to_counts(bits: torch.Tensor) -> torch.Tensor:
    """``[B, S, N]`` bit samples -> ``[B, 2^N]`` float32 outcome counts.

    A scatter-add histogram: O(B·S) work, no ``[B, S, 2^N]`` one-hot.
    """
    b, s, n = bits.shape
    powers = 1 << torch.arange(n, device=bits.device)
    idx = (bits.long() * powers).sum(-1)  # [B, S]
    out = torch.zeros((b, 2**n), dtype=torch.float32, device=bits.device)
    return out.scatter_add_(1, idx, torch.ones(idx.shape, device=bits.device))
