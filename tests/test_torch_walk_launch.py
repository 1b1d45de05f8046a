"""The walk wrapper from N = 8 on, on the CPU.

N alone chooses the kernel's body (staged up to N = 7, the ring of
shared-memory stages from 8 to 11, the gather body's 16-byte loads from
global memory from 12 to 16); the one
launch option is the block size. It is checked before the plain version is
taken, so a size the kernel would refuse raises ``ValueError`` here as on
the card (the ring body's plan may choose 96, 320 or 1,024 threads itself,
but a caller asks only for 64 to 512), and a size it takes leaves the plain
version's bits unchanged.
"""

import numpy as np
import pytest
import torch

from ddqst_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)


def _inputs(n: int):
    rng = np.random.default_rng(n)
    g = 2**n
    tables = torch.from_numpy(
        rng.uniform(0.05, 0.95, (2, 2, g, n)).astype(np.float32))
    init = torch.from_numpy(rng.integers(0, g, (2, 5)).astype(np.int32))
    return tables, init


@pytest.mark.parametrize("n", [3, 8, 11, 12, 13, 14, 15, 16])
@pytest.mark.parametrize("threads", [1024, 320, 96, 32])
def test_walk_rejects_a_block_size_the_kernel_does_not_take(n, threads):
    tables, init = _inputs(n)
    before = ck.fused_chain_walk.launches
    with pytest.raises(ValueError, match="threads"):
        ck.fused_chain_walk(7, tables, init, n, threads=threads)
    assert ck.fused_chain_walk.launches == before


@pytest.mark.parametrize("n", [1, 3, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16])
@pytest.mark.parametrize("threads", [0, 64, 512])
def test_walk_block_size_the_kernel_takes_keeps_the_plain_bits(n, threads):
    tables, init = _inputs(n)
    want = ck.fused_chain_walk_reference(7, tables, init, n)
    before = ck.fused_chain_walk.launches
    assert torch.equal(ck.fused_chain_walk(7, tables, init, n,
                                           threads=threads), want)
    assert ck.fused_chain_walk.launches == before  # the plain version

