"""Port parity: posterior, grid tables, the chain-walk kernel module and the
all-bases sampler against ddqst_tpu (CPU; the CUDA kernel itself is held
against its plain version on the card by chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddqst_tpu.models import d3pm as jd3pm
from ddqst_tpu.ops import diffusion as jdiff
from ddqst_tpu.ops import schedules as jsched
from ddqst_tpu_torch.models import d3pm as td3pm
from ddqst_tpu_torch.models import params_from_flax
from ddqst_tpu_torch.ops import cuda_kernels as ck
from ddqst_tpu_torch.ops import diffusion as tdiff
from ddqst_tpu_torch.ops import schedules as tsched

# The suite runs in several xdist workers; one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)

N, T = 3, 20


def _models(seed=1, t_steps=T):
    """A small flax model with random weights and its converted port."""
    fm = jd3pm.ConditionalD3PM(num_qubits=N, num_bases=3**N,
                               num_timesteps=t_steps, embed_dim=16,
                               hidden_dim=32, num_blocks=2,
                               input_encoding="token")
    z = jnp.zeros((2, N), jnp.int8)
    params = fm.init(jax.random.key(seed), z, jnp.ones((2,), jnp.int32),
                     jnp.zeros((2,), jnp.int32))["params"]
    tm = td3pm.ConditionalD3PM(N, 3**N, t_steps, embed_dim=16, hidden_dim=32,
                               num_blocks=2, input_encoding="token")
    tm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return fm, params, tm.eval()


def _exact_walk(tables, init_dist):
    """Exact propagation of the table walk: tables [T, C, g, N] -> [C, g]."""
    t_steps, c, g, n = tables.shape
    y = ((np.arange(g)[:, None] >> np.arange(n)) & 1).astype(np.float64)
    dist = np.array(init_dist, np.float64)
    for t in range(t_steps):
        p1 = tables[t].astype(np.float64)  # [C, g, N]
        trans = np.prod(p1[:, :, None, :] * y + (1 - p1[:, :, None, :]) * (1 - y),
                        axis=-1)  # [C, x, y]
        dist = np.einsum("cx,cxy->cy", dist, trans)
    return dist


def _tv_bound(g, s):
    return 4 * np.sqrt(g / (2 * np.pi * s))


def test_posterior_p1_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(500, N, 2)).astype(np.float32) * 3
    x = rng.integers(0, 2, (500, N)).astype(np.int8)
    beta, cum = np.float32(0.07), np.float32(0.31)
    ref = jdiff._posterior_p1(jnp.asarray(logits), jnp.asarray(x),
                              jnp.float32(beta), jnp.float32(cum))
    out = tdiff._posterior_p1(torch.from_numpy(logits), torch.from_numpy(x),
                              torch.tensor(beta), torch.tensor(cum))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("kind,exact", [("cosine", True), ("cosine", False),
                                        ("linear", False)])
@pytest.mark.parametrize("per_row", [False, True])
def test_grid_p1_table_matches_jax(kind, exact, per_row):
    """Includes the max(t-1, 0) clamp and the t > 1 guard (t = 1 rows)."""
    rng = np.random.default_rng(1)
    r = 300
    logits = rng.normal(size=(r, N, 2)).astype(np.float32) * 2
    x = rng.integers(0, 2, (r, N)).astype(np.int8)
    t = rng.integers(1, T + 1, r).astype(np.int64) if per_row else np.int64(1)
    js, ts = jsched.make_schedule(kind, T), tsched.make_schedule(kind, T)
    ref = jdiff._grid_p1_table(jnp.asarray(logits), jnp.asarray(x),
                               jnp.asarray(t.astype(np.int32)), js, exact)
    out = tdiff._grid_p1_table(torch.from_numpy(logits), torch.from_numpy(x),
                               torch.as_tensor(t), ts, exact)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_grid_enum_row_layout():
    gx, gb = tdiff._grid_enum(N, "cpu")
    jx, jb = jdiff._grid_enum(N)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(jb))


@pytest.mark.parametrize(
    "t_steps,row_budget",
    [(T, tdiff._ROW_BUDGET),  # one forward for all T
     (13, 5 * 216),           # prime T, m=5: padded with dummy t=1 rows
     (7, 100)],               # grid > budget: one timestep row-chunked
)
def test_grid_p1_tables_match_jax(t_steps, row_budget):
    fm, params, tm = _models(t_steps=t_steps)
    js = jsched.cosine_schedule(t_steps)
    ts = tsched.cosine_schedule(t_steps)

    def jfn(x, t, b):
        return fm.apply({"params": params}, x, t, b)

    ref = np.asarray(jdiff.grid_p1_tables(jfn, N, js))
    out = tdiff.grid_p1_tables(tm, N, ts, row_budget=row_budget).numpy()
    assert out.shape == ref.shape == (t_steps, 6**N, N)
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("n,c,s_chains", [(2, 3, 2100), (3, 4, 2100),
                                          (5, 2, 777)])
def test_plain_walk_matches_pallas_interpret_on_binary_tables(n, c, s_chains):
    """On 0/1 tables every u in [0, 1) gives bit = (p1 == 1), so the plain
    version must equal the JAX kernel (interpreter mode) exactly; 2,100 and
    777 chains are multiples of neither the TPU tile nor the CUDA block."""
    from jax.experimental.pallas import tpu as pltpu

    from ddqst_tpu.ops import pallas_kernels as pk

    g, t_steps = 2**n, 5
    rng = np.random.default_rng(n)
    tables = rng.integers(0, 2, (t_steps, c, g, n)).astype(np.float32)
    init = rng.integers(0, g, (c, s_chains)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pk.fused_chain_walk(jnp.int32(3), jnp.asarray(tables),
                                             jnp.asarray(init), n))
    out = ck.fused_chain_walk_reference(
        12345, torch.from_numpy(tables), torch.from_numpy(init), n)
    assert out.dtype == torch.int32 and out.shape == (c, s_chains)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_philox_known_answer():
    """Random123's published Philox4x32-10 vectors."""
    z = torch.zeros(1, dtype=torch.int64)
    out = ck.philox4x32_10((z, z, z, z), (0, 0))
    assert [int(w) for w in out] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                     0x9B00DBD8]
    f = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)
    out = ck.philox4x32_10((f, f, f, f), (0xFFFFFFFF, 0xFFFFFFFF))
    assert [int(w) for w in out] == [0x408F276D, 0x41C83B0E, 0xA20BC7C6,
                                     0x6D5451FD]
    ctr = [torch.tensor([v]) for v in (0x243F6A88, 0x85A308D3, 0x13198A2E,
                                       0x03707344)]
    out = ck.philox4x32_10(tuple(ctr), (0xA4093822, 0x299F31D0))
    assert [int(w) for w in out] == [0xD16CFE09, 0x94FDCCEB, 0x5001E420,
                                     0x24126EA1]


def test_plain_walk_uses_documented_counter_and_words():
    """One step, one chain: the bit equals [u < p1] with u from word q % 4 of
    the Philox block at counter (s, c, i, q // 4), key (seed lo, seed hi)."""
    seed, n, c, s = (7 << 32) | 99, 6, 2, 5
    rng = np.random.default_rng(0)
    tables = rng.uniform(0.2, 0.8, (1, c, 2**n, n)).astype(np.float32)
    init = rng.integers(0, 2**n, (c, s)).astype(np.int32)
    out = ck.fused_chain_walk_reference(seed, torch.from_numpy(tables),
                                        torch.from_numpy(init), n).numpy()
    for ci in range(c):
        for si in range(s):
            want = 0
            for q in range(n):
                ctr = tuple(torch.tensor([v]) for v in (si, ci, 0, q // 4))
                w = int(ck.philox4x32_10(ctr, (99, 7))[q % 4])
                u = np.float32((w >> 8) * 2.0**-24)
                want |= int(u < tables[0, ci, init[ci, si], q]) << q
            assert out[ci, si] == want


@pytest.mark.parametrize("n", [3, 6])
def test_plain_walk_distribution_matches_exact_propagation(n):
    g, t_steps, c, s = 2**n, 10, 3, 20000
    rng = np.random.default_rng(n)
    tables = rng.uniform(0.05, 0.95, (t_steps, c, g, n)).astype(np.float32)
    init = rng.integers(0, g, (c, s)).astype(np.int32)
    init_dist = np.stack([np.bincount(r, minlength=g) / s for r in init])
    exact = _exact_walk(tables, init_dist)
    out = ck.fused_chain_walk_reference(2024, torch.from_numpy(tables),
                                        torch.from_numpy(init), n).numpy()
    for ci in range(c):
        tv = 0.5 * np.abs(np.bincount(out[ci], minlength=g) / s - exact[ci]).sum()
        assert tv < _tv_bound(g, s), (ci, tv)


def test_wrapper_takes_plain_version_for_cpu_tensors_only():
    rng = np.random.default_rng(3)
    tables = torch.from_numpy(rng.uniform(0, 1, (4, 2, 8, 3)).astype(np.float32))
    init = torch.from_numpy(rng.integers(0, 8, (2, 50)).astype(np.int32))
    before = ck.fused_chain_walk.launches
    out = ck.fused_chain_walk(5, tables, init, 3)
    assert torch.equal(out, ck.fused_chain_walk_reference(5, tables, init, 3))
    assert ck.fused_chain_walk.launches == before  # plain calls never count
    with pytest.raises(ValueError):
        ck.fused_chain_walk(5, tables.double(), init, 3)
    with pytest.raises(ValueError):
        ck.fused_chain_walk(5, tables, init.long(), 3)
    with pytest.raises(ValueError):
        ck.fused_chain_walk(5, tables, init, 2)
    with pytest.raises(ValueError):
        ck.fused_chain_walk(-1, tables, init, 3)


def test_sample_all_bases_kernel_request_on_cpu_raises():
    _, _, tm = _models()
    gen = torch.Generator().manual_seed(0)
    ts = tsched.cosine_schedule(T)
    with pytest.raises(ValueError):
        tdiff.sample_all_bases(gen, tm, N, 400, ts, walk="cuda", device="cpu")


def test_sample_all_bases_has_no_plain_walk_option():
    """The walk's device decides kernel vs plain version; no option picks
    the plain walk on its own."""
    _, _, tm = _models()
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError):
        tdiff.sample_all_bases(gen, tm, N, 400, tsched.cosine_schedule(T),
                               walk="plain", device="cpu")


def test_sample_all_bases_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tm = _models()
    with pytest.raises(RuntimeError):
        tdiff.sample_all_bases(torch.Generator().manual_seed(0), tm, N, 400,
                               tsched.cosine_schedule(T))


@pytest.mark.parametrize(
    "shots,grid_mode,walk",
    [(4000, "auto", "auto"),  # 108k chains >= 32·6^N: tables + the walk's
                              # wrapper, which takes its CPU plain version
     (200, "auto", "auto"),   # 5.4k chains < 32·6^N: the per-step 'seq' path
     (600, "off", "auto")],   # per-chain p_sample
)
def test_sample_all_bases_matches_exact_chain_distribution(shots, grid_mode,
                                                           walk):
    """Per basis, the port's samples lie within the shot-noise TV bound of
    the JAX package's exact chain distribution on the same weights."""
    fm, params, tm = _models()
    js = jsched.cosine_schedule(T)
    exact = np.asarray(jdiff.sampler_distribution(
        jax.random.key(0), fm.apply, {"params": params}, N, js))  # [27, 8]
    gen = torch.Generator().manual_seed(11)
    out = tdiff.sample_all_bases(gen, tm, N, shots, tsched.cosine_schedule(T),
                                 grid_mode=grid_mode, walk=walk, device="cpu")
    assert out.shape == (3**N, shots, N) and out.dtype == torch.int8
    idx = (out.long() * (1 << torch.arange(N))).sum(-1).numpy()
    bound = _tv_bound(2**N, shots)
    for b in range(3**N):
        emp = np.bincount(idx[b], minlength=2**N) / shots
        assert 0.5 * np.abs(emp - exact[b]).sum() < bound, b


@pytest.mark.parametrize("precompute", [True, False])
@pytest.mark.parametrize("num_circuits", [0, 3])
def test_p_sample_grid_equals_the_walk_with_explicit_rows(precompute,
                                                          num_circuits):
    """p_sample_grid hands each step the chain state and a row_base made
    once. For a fixed generator seed it returns exactly what a walk returns
    that recomputes rows = row_base + x every step and calls the plain step
    on them: the generator's draws are consumed in the same order."""
    n, t_steps, b = 2, 12, 333
    torch.manual_seed(3)
    tm = td3pm.ConditionalD3PM(n, 3**n, t_steps, embed_dim=16, hidden_dim=32,
                               num_blocks=2, input_encoding="token",
                               num_circuits=num_circuits).eval()
    ts = tsched.cosine_schedule(t_steps)
    rng = np.random.default_rng(8)
    basis = torch.from_numpy(rng.integers(0, 3**n, b))
    row_base = basis * 2**n
    if num_circuits:
        circ = torch.from_numpy(rng.integers(0, num_circuits, b))
        row_base = (circ * 3**n + basis) * 2**n
        basis = torch.stack([basis, circ], -1)

    gen = torch.Generator().manual_seed(21)
    x = torch.randint(0, 2**n, (b,), generator=gen, dtype=torch.int32)
    seed = int(torch.randint(0, 2**63 - 1, (), generator=gen))
    if precompute:
        tables = tdiff.grid_p1_tables(tm, n, ts, num_circuits=num_circuits)
    else:  # the same forwards as the sampler's, so the tables agree exactly
        grid = tdiff._grid_enum(n, torch.device("cpu"), num_circuits)
        with torch.no_grad():
            tables = [tdiff._p1_rows_one_t(tm, t, *grid, ts, True, 1 << 17)
                      for t in range(t_steps, 0, -1)]
    for i in range(t_steps):
        rows = (row_base + x).to(torch.int32)
        x = ck.fused_chain_step_reference(seed, tables[i].contiguous(), rows,
                                          n, step=i)
    want = ((x[:, None] >> torch.arange(n)) & 1).to(torch.int8)

    timings = {}
    out = tdiff.p_sample_grid(torch.Generator().manual_seed(21), tm, basis, n,
                              ts, num_circuits=num_circuits,
                              precompute=precompute, timings=timings)
    assert out.dtype == torch.int8 and torch.equal(out, want)
    assert set(timings) == ({"tables", "steps"} if precompute else {"steps"})


def test_walk_wrapper_rejects_an_unknown_block_size():
    tables = torch.zeros((2, 1, 8, 3))
    init = torch.zeros((1, 4), dtype=torch.int32)
    assert torch.equal(ck.fused_chain_walk(0, tables, init, 3, threads=128),
                       ck.fused_chain_walk(0, tables, init, 3))
    with pytest.raises(ValueError):
        ck.fused_chain_walk(0, tables, init, 3, threads=96)
