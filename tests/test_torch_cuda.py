"""The CUDA chain walk and chain step on the card, and the exact chain
distribution, the MLE and distillation there against the CPU (skipped where
there is no card).

Run on a GPU machine without JAX installed (this file imports no JAX, and
``--noconftest`` skips the JAX-only test configuration):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from ddqst_tpu_torch.models import d3pm
from ddqst_tpu_torch.ops import cuda_kernels as ck
from ddqst_tpu_torch.ops import diffusion as diff
from ddqst_tpu_torch.ops import schedules

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("n,s", [(3, 5000), (3, 1237), (7, 300), (1, 33)])
def test_kernel_equals_plain_version(cuda, n, s):
    rng = np.random.default_rng(n)
    g = 2**n
    tables = torch.from_numpy(
        rng.uniform(0.05, 0.95, (30, 5, g, n)).astype(np.float32)).to(cuda)
    init = torch.from_numpy(rng.integers(0, g, (5, s)).astype(np.int32)).to(cuda)
    before = ck.fused_chain_walk.launches
    out = ck.fused_chain_walk(2**40 + 3, tables, init, n)
    torch.cuda.synchronize()
    assert ck.fused_chain_walk.launches == before + 1
    assert torch.equal(out, ck.fused_chain_walk_reference(2**40 + 3, tables,
                                                          init, n))


def test_kernel_rejects_what_it_cannot_take(cuda):
    tables = torch.zeros((1, 1, 2**17, 17), device=cuda)
    init = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="N <= 16"):
        ck.fused_chain_walk(0, tables, init, 17)  # above the kernel's limit
    with pytest.raises(ValueError):
        ck.fused_chain_walk(0, torch.zeros((2, 1, 8, 3), device=cuda),
                            init.cpu(), 3)  # mixed devices


@pytest.mark.parametrize("n,t,c,s", [
    (8, 12, 5, 1237), (9, 12, 4, 2049), (10, 12, 7, 3001), (11, 12, 3, 777),
    (12, 12, 3, 777),
    # the ring body's tails: an odd T (a short last stage load), T = 1, and
    # T below its stages x steps a stage (8 at N = 8, 4 at N = 10); 319
    # chains a row as in the chunked sampler's N = 8 grid
    (8, 7, 3, 1237), (8, 1, 3, 1237), (8, 3, 3, 1237), (8, 7, 4, 319),
    (10, 7, 3, 1237), (10, 1, 3, 1237), (10, 3, 2, 5000), (11, 5, 2, 1237),
    # the gather body, N = 12 to 16: a ragged S, an odd T and T = 1 at each
    # N; S >= 2^N at N = 12 and 13
    (12, 7, 3, 4097), (12, 1, 2, 5000), (13, 9, 3, 1237), (13, 3, 2, 8193),
    (13, 1, 2, 999), (14, 8, 2, 1237), (14, 1, 2, 777), (15, 7, 2, 1001),
    (15, 1, 2, 513), (16, 6, 2, 1237), (16, 3, 1, 999), (16, 1, 2, 4097),
])
def test_global_memory_walk_equals_plain_version(cuda, n, t, c, s):
    """From N = 8 on: the plan's body (the ring body up to N = 11, the
    gather body from 12 to 16) at every block size gives the plain
    version's bits at a ragged S and at odd and short T, from tables that
    are and are not 16-byte aligned."""
    rng = np.random.default_rng(n)
    g = 2**n
    tables = torch.from_numpy(
        rng.uniform(0.05, 0.95, (t, c, g, n)).astype(np.float32)).to(cuda)
    init = torch.from_numpy(rng.integers(0, g, (c, s)).astype(np.int32)).to(cuda)
    want = ck.fused_chain_walk_reference(2**33 + n, tables, init, n)
    before = ck.fused_chain_walk.launches
    out = ck.fused_chain_walk(2**33 + n, tables, init, n)
    torch.cuda.synchronize()
    assert ck.fused_chain_walk.launches == before + 1
    threads, steps, smem, body = ck.fused_chain_walk.last_plan
    if n <= 11:  # a ring of 2 to 4 stages of 1 or 2 step slices, then
        # a barrier and a count a stage
        stage_bytes = steps * g * n * 4
        assert body == "ring"
        assert threads % 32 == 0 and 64 <= threads <= 1024
        assert steps in (1, 2) and 2 <= smem // stage_bytes <= 4
        assert smem % stage_bytes == 4 * (8 + 4)
    else:  # nothing staged; shared memory only as a reservation that caps
        # the blocks an SM holds
        assert (body, steps) == ("gather", 0) and 0 <= smem <= 232448
    assert torch.equal(out, want)
    for threads in (64, 128, 256, 512):
        assert torch.equal(ck.fused_chain_walk(2**33 + n, tables, init, n,
                                               threads=threads), want), threads
        plan = ck.fused_chain_walk.last_plan
        assert (plan[0], plan[3]) == (threads, body), plan
    for words in (1, 2) if n >= 12 else (1,):
        assert torch.equal(ck.fused_chain_walk(
            2**33 + n, _offset_by_one_word(tables, words), init, n),
            want), words


def test_shadow_samplers_reach_the_kernel(cuda):
    """sample_for_bases in tables mode (N = 8, 2^N = 256) and
    sample_all_bases_chunked each launch the walk once a shot chunk."""
    from ddqst_tpu_torch.models import TransformerDenoiser

    model = TransformerDenoiser(8, 10, embed_dim=16, hidden_dim=32,
                                num_blocks=1, num_heads=2).to(cuda).eval()
    sched = schedules.cosine_schedule(10, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    labels = torch.randint(0, 3, (4, 8), device=cuda)
    before = ck.fused_chain_walk.launches
    out = diff.sample_for_bases(gen, model, labels, 300, sched)
    assert ck.fused_chain_walk.launches == before + 1
    assert out.shape == (4, 300, 8) and out.is_cuda
    small = d3pm.ConditionalD3PM(3, 27, 10, embed_dim=16, hidden_dim=32,
                                 num_blocks=1, input_encoding="token").to(cuda)
    out = diff.sample_all_bases_chunked(gen, small, 3, 100, sched,
                                        max_chains=27 * 40, walk="cuda")
    assert ck.fused_chain_walk.launches == before + 4  # 100 shots, 40 a call
    assert out.shape == (27, 100, 3) and out.is_cuda


def test_sample_all_bases_auto_reaches_the_kernel(cuda):
    model = d3pm.ConditionalD3PM(3, 27, 20, embed_dim=16, hidden_dim=32,
                                 num_blocks=2, input_encoding="token").to(cuda)
    sched = schedules.cosine_schedule(20, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    before = ck.fused_chain_walk.launches
    out = diff.sample_all_bases(gen, model, 3, 5000, sched)
    assert ck.fused_chain_walk.launches == before + 1
    assert out.shape == (27, 5000, 3) and out.is_cuda


@pytest.mark.parametrize("g,n,b", [(50 * 27 * 8, 3, 200_000), (216, 3, 1237),
                                   (3**7 * 2**7, 7, 5000), (2, 1, 33)])
def test_step_kernel_equals_plain_version(cuda, g, n, b):
    rng = np.random.default_rng(g)
    table = torch.from_numpy(
        rng.uniform(0.05, 0.95, (g, n)).astype(np.float32)).to(cuda)
    rows = torch.from_numpy(rng.integers(0, g, b).astype(np.int32)).to(cuda)
    before = ck.fused_chain_step.launches
    out = ck.fused_chain_step(2**50 + 1, table, rows, n, step=17)
    torch.cuda.synchronize()
    assert ck.fused_chain_step.launches == before + 1
    assert torch.equal(out, ck.fused_chain_step_reference(2**50 + 1, table,
                                                          rows, n, step=17))


def test_step_kernel_rejects_what_it_cannot_take(cuda):
    table = torch.zeros((8, 3), device=cuda)
    rows = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ck.fused_chain_step(0, table, rows.cpu(), 3)  # mixed devices
    with pytest.raises(ValueError):
        ck.fused_chain_step(0, table, rows.long(), 3)  # int64 rows
    with pytest.raises(ValueError):
        ck.fused_chain_step(0, table[:, :2], rows, 2)  # not contiguous
    with pytest.raises(ValueError):
        ck.fused_chain_step(0, torch.zeros((8, 31), device=cuda), rows, 31)


@pytest.mark.parametrize("precompute", [True, False])
def test_p_sample_grid_runs_the_step_kernel_per_step(cuda, precompute):
    model = d3pm.ConditionalD3PM(2, 9, 20, embed_dim=16, hidden_dim=32,
                                 num_blocks=2, input_encoding="token",
                                 num_circuits=3).to(cuda)
    sched = schedules.cosine_schedule(20, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    packed = torch.stack([torch.arange(9, device=cuda).repeat(30),
                          torch.arange(3, device=cuda).repeat_interleave(90)],
                         -1)
    before = ck.fused_chain_step.launches
    out = diff.p_sample_grid(gen, model, packed, 2, sched, num_circuits=3,
                             precompute=precompute)
    assert ck.fused_chain_step.launches == before + 20
    assert out.shape == (270, 2) and out.is_cuda


def _offset_by_one_word(t, words=1):
    """The same values at an address that is 4 bytes (or 4 x ``words``) off
    16-byte alignment (contiguous still): the kernels then take their 4-byte
    accesses (the gather body its 8-byte ones at 8 bytes off and even N)."""
    buf = torch.empty(t.numel() + words, dtype=t.dtype, device=t.device)
    buf[words:] = t.reshape(-1)
    return buf[words:].view(t.shape)


@pytest.mark.parametrize("n,t_steps,s,regime", [
    (1, 30, 33, "slices of 8 bytes: plain loads"),
    (5, 100, 700, "all T slices at once, 64 KB of dynamic shared memory"),
    (6, 100, 301, "a ring of two chunks"),
    (3, 1000, 130, "small slices, too many steps to hold: a ring"),
])
def test_walk_kernel_staging_regimes(cuda, n, t_steps, s, regime):
    rng = np.random.default_rng(10 * n)
    g = 2**n
    tables = torch.from_numpy(
        rng.uniform(0.05, 0.95, (t_steps, 3, g, n)).astype(np.float32)).to(cuda)
    init = torch.from_numpy(rng.integers(0, g, (3, s)).astype(np.int32)).to(cuda)
    want = ck.fused_chain_walk_reference(99, tables, init, n)
    out = ck.fused_chain_walk(99, tables, init, n)
    torch.cuda.synchronize()
    assert torch.equal(out, want), regime
    shifted = ck.fused_chain_walk(99, _offset_by_one_word(tables), init, n)
    assert torch.equal(shifted, want), "a table that is not 16-byte aligned"


@pytest.mark.parametrize("n", [3, 7])
def test_walk_kernel_result_does_not_depend_on_the_block_size(cuda, n):
    rng = np.random.default_rng(n)
    g = 2**n
    tables = torch.from_numpy(
        rng.uniform(0.05, 0.95, (40, 4, g, n)).astype(np.float32)).to(cuda)
    init = torch.from_numpy(rng.integers(0, g, (4, 1237)).astype(np.int32)
                            ).to(cuda)
    want = ck.fused_chain_walk(5, tables, init, n)
    assert ck.fused_chain_walk.last_plan[0] in (64, 128, 256, 512)
    for threads in (64, 128, 256, 512):
        out = ck.fused_chain_walk(5, tables, init, n, threads=threads)
        assert ck.fused_chain_walk.last_plan[0] == threads
        assert torch.equal(out, want), threads


@pytest.mark.parametrize("g,n,b", [
    (50 * 27 * 8, 3, 200_000),   # the evaluation table, B a multiple of 4
    (216, 3, 1237),              # B mod 4 = 1
    (3**7 * 2**7, 7, 5003),      # N = 7, B mod 4 = 3
    (2, 1, 33),
    (40 * 16, 11, 3001),         # N above 8: the runtime-N body
])
def test_step_kernel_row_base_form_and_ragged_ends(cuda, g, n, b):
    rng = np.random.default_rng(g + n)
    table = torch.from_numpy(
        rng.uniform(0.05, 0.95, (g, n)).astype(np.float32)).to(cuda)
    span = min(2**n, g)
    x = torch.from_numpy(rng.integers(0, span, b).astype(np.int32)).to(cuda)
    rb = torch.from_numpy(
        (rng.integers(0, g // span, b) * span).astype(np.int32)).to(cuda)
    want = ck.fused_chain_step_reference(2**45 + 7, table, rb + x, n, step=3)
    before = ck.fused_chain_step.launches
    out = ck.fused_chain_step(2**45 + 7, table, x, n, step=3, row_base=rb)
    rows_form = ck.fused_chain_step(2**45 + 7, table, rb + x, n, step=3)
    shifted = ck.fused_chain_step(2**45 + 7, table, _offset_by_one_word(x), n,
                                  step=3, row_base=rb)
    torch.cuda.synchronize()
    assert ck.fused_chain_step.launches == before + 3
    assert torch.equal(out, want)
    assert torch.equal(rows_form, want)
    assert torch.equal(shifted, want), "a state that is not 16-byte aligned"


def test_step_kernel_rejects_a_bad_row_base(cuda):
    table = torch.zeros((8, 3), device=cuda)
    x = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ck.fused_chain_step(0, table, x, 3, row_base=x.cpu())  # mixed devices
    with pytest.raises(ValueError):
        ck.fused_chain_step(0, table, x, 3, row_base=x.long())  # int64
    with pytest.raises(ValueError):
        ck.fused_chain_step(0, table, x, 3, row_base=x[:3])  # another length


def _small_model(device):
    model = d3pm.ConditionalD3PM(3, 27, 10, embed_dim=16, hidden_dim=32,
                                 num_blocks=2, input_encoding="token")
    d3pm.init_params_(model, torch.Generator().manual_seed(0))
    with torch.no_grad():  # the zero-initialised head would hide the network
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape,
                                     generator=torch.Generator().manual_seed(1)))
    return model.to(device)


def test_chain_distribution_on_the_card_equals_the_cpu(cuda):
    """The exact chain distribution and its gradient, card against CPU
    (float32, TF32 off): 1e-5 per entry, 1e-4 relative per gradient."""
    out = []
    for dev in ("cpu", cuda):
        model = _small_model(dev)
        dist = diff.chain_distribution(model, 3, schedules.cosine_schedule(10, dev),
                                       exact=False)
        dist[:, 0].log().sum().backward()
        out.append((dist.detach().cpu(),
                    [p.grad.cpu() for p in model.parameters()]))
    (d0, g0), (d1, g1) = out
    assert d1.shape == (27, 8)
    torch.testing.assert_close(d1, d0, rtol=0, atol=1e-5)
    for a, b in zip(g1, g0):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.parametrize("impl,readout_p", [("dense", 0.0), ("dense", 0.02),
                                            ("factored", 0.02)])
def test_mle_on_the_card_equals_the_cpu(cuda, impl, readout_p):
    from ddqst_tpu_torch.ops import mle

    rng = np.random.default_rng(3)
    counts = torch.from_numpy(np.stack(
        [rng.multinomial(2000, q) for q in rng.dirichlet(np.ones(8), size=27)]
    ).astype(np.float32))
    rec = mle.make_mle(3, readout_p=readout_p, impl=impl)
    info = {}
    rho = rec(counts.to(cuda), info)
    assert rho.is_cuda and 1 < info["iterations"] <= 4000
    # 2e-4 per entry: the tolerance two float32 solves are held to.
    torch.testing.assert_close(rho.cpu(), rec(counts), rtol=0, atol=2e-4)


def test_finetune_chain_on_the_card_follows_the_cpu(cuda):
    """Full-batch distillation draws nothing: the card's losses follow the
    CPU's within 1e-4 relative, and the walk is not launched."""
    from ddqst_tpu_torch import train

    rng = np.random.default_rng(5)
    tgt = np.stack([rng.multinomial(300, q)
                    for q in rng.dirichlet(np.ones(8), size=27)])
    before = ck.fused_chain_walk.launches
    runs = [train.finetune_chain(_small_model("cpu"), tgt,
                                 schedules.cosine_schedule(10), 3, steps=5,
                                 learning_rate=1e-3, exact=False, device=dev)
            for dev in ("cpu", cuda)]
    assert ck.fused_chain_walk.launches == before
    (_, l0, i0), (m1, l1, i1) = runs
    assert l1.is_cuda and next(m1.parameters()).is_cuda
    np.testing.assert_allclose(l1.cpu().numpy(), l0.numpy(), rtol=1e-4)
    assert i1["train_ce_after"] == pytest.approx(i0["train_ce_after"],
                                                 rel=1e-4)


def _tv_bound(g, shots):
    return 4 * np.sqrt(g / (2 * np.pi * shots))  # 4 shot-noise scales


@pytest.mark.parametrize("n", [1, 2])
def test_plain_mlp_tables_and_walk_on_the_card(cuda, n):
    """A notebook-width PlainMLP on the card: its grid tables equal the
    CPU's, ``sample_all_bases`` takes one walk launch (3^N x 20,000 chains,
    above 32·6^N), and the samples follow the exact chain distribution."""
    from ddqst_tpu_torch.config import ModelConfig
    from ddqst_tpu_torch.models import build_model

    model = build_model(ModelConfig(arch="plain_mlp", embed_dim=32,
                                    hidden_dim=128, num_blocks=2), n, 100)
    d3pm.init_params_(model, torch.Generator().manual_seed(n))
    with torch.no_grad():  # the zero-initialised head would hide the network
        model.output_head.weight.normal_(
            0, 0.3, generator=torch.Generator().manual_seed(9))
    sched = schedules.notebook_schedule(100)
    cpu_tables = diff.grid_p1_tables(model.eval(), n, sched)
    dist = diff.sampler_distribution(model, n, sched).double()
    model = model.to(cuda)
    sched_c = sched.to(cuda)
    torch.testing.assert_close(diff.grid_p1_tables(model, n, sched_c).cpu(),
                               cpu_tables, rtol=0, atol=1e-5)
    shots = 20_000
    before = ck.fused_chain_walk.launches
    out = diff.sample_all_bases(torch.Generator(device=cuda).manual_seed(0),
                                model, n, shots, sched_c)
    torch.cuda.synchronize()
    assert ck.fused_chain_walk.launches == before + 1
    assert out.shape == (3**n, shots, n) and out.is_cuda
    idx = (out.long() * (1 << torch.arange(n, device=cuda))).sum(-1).cpu()
    hist = torch.stack([torch.bincount(r, minlength=2**n) for r in idx]) / shots
    tv = 0.5 * (hist.double() - dist).abs().sum(-1)
    assert bool((tv < _tv_bound(2**n, shots)).all()), tv


@pytest.mark.parametrize("exact", [True, False])
def test_p_denoise_on_the_card_follows_the_exact_propagation(cuda, exact):
    """Denoise mode on the card, from fixed one-hot starts: the histogram is
    within 4 shot-noise scales (TV) of the exact propagation of the model's
    grid tables (computed on the CPU) over steps t*..1; no kernel runs."""
    t_steps, t_star, shots = 10, 4, 50_000
    sched = schedules.cosine_schedule(t_steps)
    tables = diff.grid_p1_tables(_small_model("cpu").eval(), 3, sched,
                                 exact=exact).double().reshape(t_steps, 27, 8, 3)
    y = ((torch.arange(8)[:, None] >> torch.arange(3)) & 1).double()
    starts = [(26, 0), (5, 7), (13, 2)]
    basis = torch.tensor([b for b, _ in starts]).repeat_interleave(shots)
    x0 = torch.tensor([[(x >> q) & 1 for q in range(3)] for _, x in starts],
                      dtype=torch.int8).repeat_interleave(shots, dim=0)
    before = (ck.fused_chain_walk.launches, ck.fused_chain_step.launches)
    out = diff.p_denoise(torch.Generator(device=cuda).manual_seed(0),
                         _small_model(cuda).eval(), x0.to(cuda),
                         basis.to(cuda), t_star, sched.to(cuda), exact=exact)
    torch.cuda.synchronize()
    assert (ck.fused_chain_walk.launches, ck.fused_chain_step.launches) == before
    assert out.is_cuda and out.dtype == torch.int8
    idx = (out.long().cpu() * (1 << torch.arange(3))).sum(-1).reshape(3, shots)
    for row, (b, x) in enumerate(starts):
        dist = torch.zeros(8, dtype=torch.float64)
        dist[x] = 1.0
        for t in range(t_star, 0, -1):
            p1 = tables[t_steps - t, b][:, None, :]
            dist = dist @ (p1 * y + (1 - p1) * (1 - y)).prod(-1)
        hist = torch.bincount(idx[row], minlength=8).double() / shots
        tv = float(0.5 * (hist - dist).abs().sum())
        assert tv < _tv_bound(8, shots), (b, x, tv)


def test_checkpoint_resume_on_the_card(cuda, tmp_path):
    """``fit`` on the card saves model, optimiser, step and the CUDA
    generator's state, and a resume runs the remaining epochs from them:
    the resumed run's losses follow the uninterrupted run's (not bit for
    bit: the card's embedding backward accumulates with atomics)."""
    import dataclasses

    from ddqst_tpu_torch import train
    from ddqst_tpu_torch.config import TrainConfig
    from ddqst_tpu_torch.utils import checkpoint as ckpt

    rng = np.random.default_rng(0)
    bits = torch.from_numpy(rng.integers(0, 2, (2048, 3)).astype(np.int8))
    basis = torch.from_numpy(rng.integers(0, 27, 2048))
    cfg = TrainConfig(batch_size=256, num_epochs=2, optimizer="adam",
                      learning_rate=1e-3, log_every=0, eval_every=0,
                      checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)

    def run(c, seed):
        return train.fit(torch.Generator(device=cuda).manual_seed(seed),
                         _small_model("cpu"), bits, basis, c,
                         schedules.cosine_schedule(10), device=cuda,
                         log_fn=lambda m: None)

    run(cfg, 0)
    model, losses = run(dataclasses.replace(cfg, num_epochs=4, resume=True), 9)
    assert losses.shape == (2,) and losses.is_cuda
    assert next(model.parameters()).is_cuda
    state, step = ckpt.restore_checkpoint(cfg.checkpoint_dir)
    assert step == 4 and state["step"] == 4 * (2048 // 256)
    _, whole = run(dataclasses.replace(cfg, num_epochs=4, checkpoint_dir=""), 0)
    np.testing.assert_allclose(losses.cpu().numpy(), whole[2:].cpu().numpy(),
                               rtol=1e-3)


def test_tensor_parallel_forward_on_the_card(cuda, tmp_path):
    """Two ranks on the card (gloo): the shadow width's split forward equals
    the whole one within 2e-5 (tests/test_parallel.py's tolerance)."""
    import test_torch_parallel_workers as workers

    for out in workers.spawn_world(workers.cuda_tp_forward, 2, str(tmp_path)):
        assert out["device"] == "cuda:0" and out["err"] < 2e-5


def test_one_rank_nccl_fit_equals_the_mesh_less_fit(cuda, monkeypatch):
    """``init_distributed`` from a torchrun environment of one rank joins
    over NCCL, and ``fit`` on ``make_mesh(data=1)`` gives the mesh-less
    losses at rtol 2e-4, atol 2e-5 (the card's backward is not
    bit-reproducible)."""
    from ddqst_tpu_torch import train as training
    from ddqst_tpu_torch.config import TrainConfig
    from ddqst_tpu_torch.parallel import mesh as pm

    for var, value in dict(MASTER_ADDR="localhost", MASTER_PORT=str(
            pm.free_port()), WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
            LOCAL_WORLD_SIZE="1").items():
        monkeypatch.setenv(var, value)
    rng = np.random.default_rng(0)
    bits = torch.from_numpy(rng.integers(0, 2, (2048, 3)).astype(np.int8))
    basis = torch.from_numpy(rng.integers(0, 27, (2048,)))
    cfg = TrainConfig(batch_size=256, num_epochs=2, log_every=0)

    def run(mesh):
        model = d3pm.ConditionalD3PM(3, 27, 20, embed_dim=32, hidden_dim=128,
                                     num_blocks=2, input_encoding="token")
        return training.fit(torch.Generator(device=cuda).manual_seed(0), model,
                            bits, basis, cfg, schedules.cosine_schedule(20),
                            mesh=mesh, log_fn=lambda m: None)[1]

    plain = run(None)
    assert pm.init_distributed()
    try:
        mesh = pm.make_mesh(data=1)
        assert mesh.backend == "nccl" and mesh.device == cuda
        on_mesh = run(mesh)
    finally:
        torch.distributed.destroy_process_group()
    torch.testing.assert_close(on_mesh, plain, rtol=2e-4, atol=2e-5)


def test_bench_walk_part_demands_the_cuda_walk(cuda):
    """The bench's 10^6-chain part on the card asks ``sample_all_bases`` for
    the CUDA walk: one walk launch a call, no step launch."""
    from ddqst_tpu_torch import bench
    from ddqst_tpu_torch.config import get_preset

    cfg = get_preset("rqc")
    model = d3pm.build_model(cfg.model, 3, 100).to(cuda).eval()
    rec = bench.measure_walk_1m(model, cfg, cuda, 1000, 2)
    assert rec["walk"] == "cuda" and rec["calls"] == 4
    assert rec["walk_launches"] == 4 and rec["step_launches"] == 0
    assert rec["plan"][3] == "staged" and rec["per_sec_min"] > 0


@pytest.mark.parametrize("rows,m,e", [
    (2, 10240, 128),  # the shadow width's bit_emb: 1,024 rows x N = 10
    (3, 10240, 128),  # its basis_emb
    (101, 1024, 128),  # time_emb at T = 100, one CE batch
    (101, 81 * 16, 128),  # time_emb under chain_distribution: one t a row
    (6561, 1024, 128),  # basis_emb at N = 8 (torch.unique's path)
])
def test_embed_backward_repeats_bit_for_bit(cuda, rows, m, e):
    """``d3pm.embed``'s backward twice on one weight, one index tensor and
    one output gradient: the two gradients are equal bit for bit, and equal
    ``nn.Embedding``'s within float rounding (1e-5 of the largest entry);
    the lookup is ``nn.Embedding``'s bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(rows)
    table = torch.nn.Embedding(rows, e).to(cuda)
    idx = torch.randint(0, rows, (m,), generator=gen, device=cuda)
    if m == 81 * 16:
        idx = torch.full((m,), 57, device=cuda)
    grad_out = torch.randn((m, e), generator=gen, device=cuda)
    grads = []
    for _ in range(2):
        table.weight.grad = None
        out = d3pm.embed(table, idx, torch.float32)
        out.backward(grad_out)
        grads.append(table.weight.grad.clone())
    assert torch.equal(grads[0], grads[1])
    assert torch.equal(out.detach(), table(idx).detach())
    table.weight.grad = None
    table(idx).backward(grad_out)
    ref = table.weight.grad
    assert float((grads[0] - ref).abs().max()) <= 1e-5 * float(
        ref.abs().max())


def test_shadow_sector_profile_on_the_card_reproduces_the_record(cuda,
                                                                 tmp_path):
    """``campaigns.shadow_sector_profile`` on the card at full width
    (transformer 128 / 512 / 4 / 4, N = 10, T = 100) on the reference's CE
    snapshot and data cache: the selection is the JAX package's record's
    48 bases, and on its first 2 each ``kl_clean`` and ``kl_counts`` lies
    within 1e-4 + 1e-3·|the record's| of ``examples/shadow_sector_profile.
    jsonl``; no kernel launches."""
    import os

    from ddqst_tpu_torch import pipeline
    from ddqst_tpu_torch.campaigns import read_rows
    from ddqst_tpu_torch.campaigns import shadow_sector_profile as ssp

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params = os.path.join(root, "examples", "reference_params",
                          "dist_seg_ce_params.pt")
    cache = os.path.join(root, "shadow_work", "dist_seg_data.npz")
    record = read_rows(os.path.join(root, "examples",
                                    "shadow_sector_profile.jsonl"))
    args = ssp.parse_args([params, "--data", cache,
                           "--out", str(tmp_path / "port.jsonl")])
    b_all = pipeline.load_data_cache(cache).bits.shape[0]
    sel = ssp.select(b_all, args.bases, args.seed)
    assert sel.tolist() == [r["basis"] for r in record]
    ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
    rows = ssp.run(args, log_fn=lambda m: None, limit=2)
    assert ck.fused_chain_walk.launches == ck.fused_chain_step.launches == 0
    assert len(rows) == 2
    for got, want in zip(rows, record):
        assert got["basis"] == want["basis"]
        for k in ("kl_clean", "kl_counts"):
            assert abs(got[k] - want[k]) <= 1e-4 + 1e-3 * abs(want[k]), (
                k, got, want)
