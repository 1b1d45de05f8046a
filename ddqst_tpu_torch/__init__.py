"""PyTorch / CUDA port of ``ddqst_tpu`` for NVIDIA Hopper (H100).

The JAX package ``ddqst_tpu`` is the reference; this package keeps its
module names and layout (``config``, ``pipeline``, ``train``,
``models/d3pm``, ``ops/{schedules,diffusion,pauli,mle,metrics}``,
``qsim/*``) and imports nothing of it. The TPU's Pallas chain walk is a
hand-written CUDA kernel (``csrc/chain_walk.cu``, bound in
``ops/cuda_kernels.py``).

Precision: the port computes in full float32. TF32 is switched off for
matmuls and cuDNN here, at import, because the estimators and the
probability tables that feed the sampler need float32 (TF32 keeps about
three decimal digits).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
