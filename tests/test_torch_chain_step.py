"""Port parity: the chain-step kernel module against ddqst_tpu (CPU; the CUDA
kernel itself is held against its plain version on the card by
chip_smoke.py and tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddqst_tpu_torch.ops import cuda_kernels as ck

# The suite runs in several xdist workers; one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)


def _tv_bound(g, s):
    return 4 * np.sqrt(g / (2 * np.pi * s))


@pytest.mark.parametrize("n,g,b,binary", [
    (3, 27 * 8, 4096, "random"),  # the JAX package's gather-and-pack case
    (2, 9 * 4, 37, "eye"),        # 37 chains: not a multiple of any tile
])
def test_plain_step_matches_pallas_interpret_on_binary_tables(n, g, b, binary):
    """On 0/1 tables every u in [0, 1) gives bit = (p1 == 1), as the Pallas
    interpreter's zero random bits do, so the two agree exactly."""
    from jax.experimental.pallas import tpu as pltpu

    from ddqst_tpu.ops import pallas_kernels as pk

    rng = np.random.default_rng(0)
    if binary == "random":
        table = rng.integers(0, 2, (g, n)).astype(np.float32)
        rows = rng.integers(0, g, b).astype(np.int32)
    else:
        table = np.eye(g, n, dtype=np.float32)
        rows = (np.arange(b) % g).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pk.fused_chain_step(jnp.int32(1234), jnp.asarray(table),
                                             jnp.asarray(rows), n))
    out = ck.fused_chain_step_reference(2**40 + 9, torch.from_numpy(table),
                                        torch.from_numpy(rows), n, step=5)
    assert out.dtype == torch.int32 and out.shape == (b,)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_plain_step_uses_documented_counter_and_words():
    """Chain b, bit q: [u < p1] with u from word q % 4 of the Philox block at
    counter (b, step, q // 4, 0), key (seed lo, seed hi)."""
    seed, n, g, b, step = (5 << 32) | 77, 6, 12, 9, 41
    rng = np.random.default_rng(1)
    table = rng.uniform(0.2, 0.8, (g, n)).astype(np.float32)
    rows = rng.integers(0, g, b).astype(np.int32)
    out = ck.fused_chain_step_reference(seed, torch.from_numpy(table),
                                        torch.from_numpy(rows), n,
                                        step=step).numpy()
    for bi in range(b):
        want = 0
        for q in range(n):
            ctr = tuple(torch.tensor([v]) for v in (bi, step, q // 4, 0))
            w = int(ck.philox4x32_10(ctr, (77, 5))[q % 4])
            u = np.float32((w >> 8) * 2.0**-24)
            want |= int(u < table[rows[bi], q]) << q
        assert out[bi] == want


def test_step_and_seed_change_the_draw():
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.uniform(0.3, 0.7, (40, 4)).astype(np.float32))
    rows = torch.from_numpy(rng.integers(0, 40, 2000).astype(np.int32))
    base = ck.fused_chain_step(11, table, rows, 4, step=3)
    assert torch.equal(base, ck.fused_chain_step(11, table, rows, 4, step=3))
    assert not torch.equal(base, ck.fused_chain_step(11, table, rows, 4, step=4))
    assert not torch.equal(base, ck.fused_chain_step(12, table, rows, 4, step=3))


@pytest.mark.parametrize("n", [3, 7])
def test_one_row_histogram_matches_product_bernoulli(n):
    g, b = 2**n, 100_000
    rng = np.random.default_rng(n)
    p1 = rng.uniform(0.05, 0.95, n).astype(np.float32)
    out = ck.fused_chain_step_reference(
        31, torch.from_numpy(p1[None]), torch.zeros(b, dtype=torch.int32), n,
        step=2).numpy()
    y = (np.arange(g)[:, None] >> np.arange(n)) & 1
    exact = np.prod(np.where(y == 1, p1.astype(np.float64), 1 - p1), axis=1)
    tv = 0.5 * np.abs(np.bincount(out, minlength=g) / b - exact).sum()
    assert tv < _tv_bound(g, b), tv


def test_wrapper_takes_plain_version_for_cpu_tensors_only():
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.uniform(0, 1, (24, 3)).astype(np.float32))
    rows = torch.from_numpy(rng.integers(0, 24, 300).astype(np.int32))
    before = ck.fused_chain_step.launches
    out = ck.fused_chain_step(5, table, rows, 3, step=1)
    assert torch.equal(out, ck.fused_chain_step_reference(5, table, rows, 3, 1))
    assert ck.fused_chain_step.launches == before  # plain calls never count


@pytest.mark.parametrize("bad", [
    dict(table=lambda t: t.double()),                      # not float32
    dict(rows=lambda r: r.long()),                         # not int32
    dict(n=2),                                             # N != table width
    dict(seed=-1),                                         # seed out of range
    dict(step=2**32),                                      # step out of range
    dict(table=lambda t: t.t().contiguous().t()),          # not contiguous
    dict(rows=lambda r: torch.full_like(r, 24)),           # row id >= G
])
def test_step_rejects_what_it_cannot_take(bad):
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.uniform(0, 1, (24, 3)).astype(np.float32))
    rows = torch.from_numpy(rng.integers(0, 24, 50).astype(np.int32))
    args = dict(seed=1, table=table, rows=rows, n=3, step=0)
    for k, v in bad.items():
        args[k] = v(args[k]) if callable(v) else v
    with pytest.raises(ValueError):
        ck.fused_chain_step(args["seed"], args["table"], args["rows"],
                            args["n"], step=args["step"])
