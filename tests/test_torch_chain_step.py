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


@pytest.mark.parametrize("n,g,b", [(1, 6, 33), (3, 27 * 8, 1237),
                                   (7, 9 * 128, 301)])
def test_row_base_form_equals_rows_form(n, g, b):
    """With row_base the second tensor is the chain state x and the row read
    is row_base + x: bit for bit the old form on rows = row_base + x. The
    chain counts are multiples of neither 4 nor a block."""
    rng = np.random.default_rng(n)
    table = torch.from_numpy(rng.uniform(0.05, 0.95, (g, n)).astype(np.float32))
    x = torch.from_numpy(rng.integers(0, 2**n, b).astype(np.int32))
    rb = torch.from_numpy(
        (rng.integers(0, g // 2**n, b) * 2**n).astype(np.int32))
    want = ck.fused_chain_step_reference(77, table, rb + x, n, step=9)
    for fn in (ck.fused_chain_step, ck.fused_chain_step_reference):
        out = fn(77, table, x, n, step=9, row_base=rb)
        assert out.dtype == torch.int32 and torch.equal(out, want)


@pytest.mark.parametrize("bad", [
    lambda rb: rb.long(),                                  # not int32
    lambda rb: rb[:-1],                                    # another length
    lambda rb: rb[None],                                   # not 1-D
    lambda rb: rb.to("meta"),                              # another device
    lambda rb: rb.repeat_interleave(2)[::2],               # not contiguous
    lambda rb: rb + 24,                                    # row id >= G
])
def test_step_rejects_a_bad_row_base(bad):
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.uniform(0, 1, (24, 3)).astype(np.float32))
    x = torch.from_numpy(rng.integers(0, 8, 50).astype(np.int32))
    rb = torch.from_numpy((rng.integers(0, 3, 50) * 8).astype(np.int32))
    ck.fused_chain_step(1, table, x, 3, row_base=rb)  # the good one passes
    with pytest.raises(ValueError):
        ck.fused_chain_step(1, table, x, 3, row_base=bad(rb))


def _threshold(p):
    """ceil(p * 2^24) saturated to uint32, 0 for NaN: what the kernels'
    float -> uint32 round-up conversion gives, computed exactly."""
    y = np.float64(p) * 2.0**24  # exact: float32 times a power of two
    if np.isnan(y):
        return 0
    return int(min(max(np.ceil(y), 0.0), 2.0**32 - 1))


def test_integer_threshold_equals_the_float_compare():
    """(k * 2^-24 < p) == (k < ceil(p * 2^24)) for every float32 p and every
    24-bit k: the kernels compare integers, the plain versions floats."""
    rng = np.random.default_rng(6)
    tiny = np.float32(2.0**-149)  # the smallest subnormal
    ps = np.concatenate([
        rng.uniform(0, 1, 2000).astype(np.float32),
        rng.integers(0, 2**24, 500).astype(np.float32) * np.float32(2.0**-24),
        np.array([0.0, -0.0, 1.0, tiny, 1 - 2.0**-24, 2.0**-24, 0.5, -0.25,
                  1.5, 300.0, np.inf, -np.inf, np.nan, 2.0**-30],
                 dtype=np.float32),
    ])
    for p in ps:
        thr = _threshold(p)
        ks = {0, 1, 2**23, 2**24 - 2, 2**24 - 1, int(rng.integers(0, 2**24))}
        ks |= {k for k in (thr - 1, thr, thr + 1) if 0 <= k < 2**24}
        for k in ks:
            u = np.float32(k) * np.float32(2.0**-24)  # exact in float32
            assert bool(u < p) == (k < thr), (p, k, thr)
    assert _threshold(np.float32(0.0)) == 0             # never
    assert _threshold(np.float32(np.nan)) == 0          # never
    assert _threshold(tiny) == 1                        # only k = 0
    assert _threshold(np.float32(1.0)) == 2**24         # always
    assert _threshold(np.float32(1 - 2.0**-24)) == 2**24 - 1


def test_step_timer_times_no_plain_call():
    """On CPU tensors the wrapper runs the plain version inside a
    ``StepTimer`` as outside it: the same bits, no launch and no event, and
    the summary's times are ``None``."""
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.uniform(0, 1, (24, 3)).astype(np.float32))
    rows = torch.from_numpy(rng.integers(0, 24, 300).astype(np.int32))
    before = ck.fused_chain_step.launches
    with ck.StepTimer() as timer:
        out = ck.fused_chain_step(5, table, rows, 3, step=1)
    assert torch.equal(out, ck.fused_chain_step_reference(5, table, rows, 3, 1))
    assert ck.fused_chain_step.launches == before and not timer.pairs
    assert timer.summary() == dict(step_timed_launches=0, step_ms_total=None,
                                   step_ms_mean=None)
    assert ck.StepTimer.active is None


def test_step_timers_do_not_nest():
    with ck.StepTimer():
        with pytest.raises(RuntimeError, match="already active"):
            with ck.StepTimer():
                pass
    assert ck.StepTimer.active is None
