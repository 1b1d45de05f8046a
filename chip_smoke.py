#!/usr/bin/env python3
"""Drive the PyTorch port (``ddqst_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
result line is printed; nothing falls back to the CPU):

1. build  — compile ``ddqst_tpu_torch/csrc/chain_walk.cu`` and
   ``chain_step.cu`` with nvcc for sm_90a from the sources in this
   checkout, both at once, and print the build times and the compiler's
   register / shared-memory report;
2. kernel — hold the CUDA ``fused_chain_walk`` against its plain PyTorch
   version on the card, bit for bit, at the main-path shape (T=100, C=27,
   N=3, S=5,000), at a ragged S (1,237) and at N=7 (2^N = 128); check that
   the same seed repeats; check the walk's distribution against the exact
   propagation of its tables (TV within 4 shot-noise scales) at N=3 and
   N=7; time kernel and plain version with CUDA events at 135,000 and at
   27 x 37,037 (about 10^6) chains;
3. main path — ``run_experiment(get_preset("rqc"), seed=0)`` at full width
   on the default (CUDA) device, with the kernel's launch count set to 0
   just before and read just after; print each stage's time and the
   metrics; check that ρ is a trace-1 Hermitian PSD matrix, that the
   generated samples follow the exact chain distribution of the trained
   model's own tables, that the fidelity agrees with the inversion of that
   exact distribution, and that the tables on the card match the CPU's;
   the step kernel must not run here;
4. step   — hold the CUDA ``fused_chain_step`` against its plain version,
   bit for bit, at the circuit-conditioned evaluation shape (table
   [10,800, 3], 6,750,000 chains), at a ragged 1,237 chains on [216, 3]
   and at N=7 ([279,936, 7], 10^6 chains); check that a rerun repeats and
   another step differs; check one row's histogram against the product
   Bernoulli at N=3 and N=7; time kernel and plain version; then run
   ``sample_all_bases`` at 200 shots (the 'seq' walk), which must launch
   the step kernel once per step;
5. route  — the phase-4 dataset route on the card at the ``rqc`` width with
   circuit conditioning: ``build_dataset_chunked`` (50 circuits, two
   shards; a second call adds none), ``train_on_dataset`` (1 epoch), then
   ``evaluate_dataset(circuit_conditioned=True)`` with the launch counts
   set to 0 just before and read just after (100 step launches, no walk);
   check every (circuit, basis) row of the samples against the exact
   propagation of the model's own tables, the D3PM fidelities against the
   exact-chain inversion, the raw fidelities against the CPU's inversion,
   and every ρ for trace 1, Hermiticity and PSD.

Then it prints the kernel table as one JSON line, the card's name and power
limit as ``nvidia-smi`` gives them, and, last, the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA's data sheet (SXM)
# Scalar instruction issue: the data sheet's 67 TFLOP/s float32 rate counts
# an FMA as 2 operations, so the card issues at most 33.5e12 32-bit lane
# instructions a second (132 SMs x 128 float32 lanes x ~1.98 GHz). The walk's
# integer work (IMAD.HI, XOR, shifts) issues on the 32-bit integer pipe,
# which has no more lanes than that, so bound_ms stays a lower bound.
H100_SCALAR_OPS_PER_S = 33.5e12
PHILOX_OPS = 100  # 10 rounds x (2 mul-hi + 2 mul-lo + 4 xor + 2 key adds)
BIT_OPS = 6       # shift, int->float, scale, compare, select/or, table load


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def walk_bound_ms(t_steps: int, c: int, n: int, s: int) -> tuple[float, str]:
    """Least time for the walk: bytes (tables, init and out, each once) over
    the memory rate vs integer instructions over the scalar issue rate."""
    g = 2**n
    nbytes = 4 * (t_steps * c * g * n + 2 * c * s)
    ops = c * s * t_steps * (math.ceil(n / 4) * PHILOX_OPS + n * BIT_OPS)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def step_bound_ms(b: int, n: int, g: int) -> tuple[float, str]:
    """Least time for one chain step: bytes (table, rows and out, each once)
    over the memory rate vs integer instructions over the scalar issue
    rate, with the walk's constants."""
    nbytes = 4 * (g * n + 2 * b)
    ops = b * (math.ceil(n / 4) * PHILOX_OPS + n * BIT_OPS)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, iters: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def exact_walk(tables: torch.Tensor, init_dist: torch.Tensor) -> torch.Tensor:
    """Exact propagation of the table walk in float64: [T,C,g,N] -> [C,g]."""
    t_steps, c, g, n = tables.shape
    y = ((torch.arange(g, device=tables.device)[:, None]
          >> torch.arange(n, device=tables.device)) & 1).double()
    dist = init_dist.double()
    for t in range(t_steps):
        p1 = tables[t].double()[:, :, None, :]  # [C, x, 1, N]
        trans = (p1 * y + (1 - p1) * (1 - y)).prod(-1)  # [C, x, y]
        dist = torch.einsum("cx,cxy->cy", dist, trans)
    return dist


def tv_rows(idx: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    g = dist.shape[-1]
    s = idx.shape[-1]
    hist = torch.zeros_like(dist).scatter_add_(
        1, idx.long(), torch.ones(idx.shape, dtype=dist.dtype, device=idx.device))
    return 0.5 * (hist / s - dist).abs().sum(-1)


def random_walk_inputs(t_steps, c, n, s, seed):
    rng = np.random.default_rng(seed)
    g = 2**n
    tables = rng.uniform(0.05, 0.95, (t_steps, c, g, n)).astype(np.float32)
    init = rng.integers(0, g, (c, s)).astype(np.int32)
    return (torch.from_numpy(tables).cuda(), torch.from_numpy(init).cuda())


def phase_kernel(ck) -> dict:
    """Kernel vs plain version on the card; returns the timing record."""
    shapes = [(100, 27, 3, 5000), (100, 27, 3, 1237), (100, 27, 7, 5000)]
    max_err = 0.0
    for i, (t_steps, c, n, s) in enumerate(shapes):
        tables, init = random_walk_inputs(t_steps, c, n, s, seed=i)
        seed = 0x1234_5678_9ABC + i
        out_k = ck.fused_chain_walk(seed, tables, init, n)
        out_r = ck.fused_chain_walk_reference(seed, tables, init, n)
        again = ck.fused_chain_walk(seed, tables, init, n)
        torch.cuda.synchronize()
        err = float((out_k - out_r).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(out_k, out_r),
              f"kernel == plain bit for bit at T={t_steps} C={c} N={n} S={s}")
        check(torch.equal(out_k, again), f"same seed repeats at N={n} S={s}")
        check(not torch.equal(ck.fused_chain_walk(seed + 1, tables, init, n),
                              out_k), f"another seed differs at N={n} S={s}")
        log("kernel", f"T={t_steps} C={c} N={n} S={s}: kernel == plain "
            f"(bit for bit), repeatable")

    for n in (3, 7):
        t_steps, c, s = 20, 4, 200_000
        tables, init = random_walk_inputs(t_steps, c, n, s, seed=10 + n)
        g = 2**n
        init_dist = torch.zeros((c, g), dtype=torch.float64, device="cuda")
        init_dist.scatter_add_(1, init.long(), torch.ones(init.shape,
                               dtype=torch.float64, device="cuda"))
        exact = exact_walk(tables, init_dist / s)
        tv = tv_rows(ck.fused_chain_walk(77, tables, init, n), exact)
        bound = 4 * math.sqrt(g / (2 * math.pi * s))
        check(bool((tv < bound).all()), f"TV {tv.tolist()} < {bound} at N={n}")
        log("kernel", f"TV vs exact propagation N={n}: max {float(tv.max()):.5f}"
            f" < bound {bound:.5f}")

    rec = {}
    for label, s, it_k, it_r in (("main", 5000, 50, 3), ("1e6", 37037, 20, 2)):
        tables, init = random_walk_inputs(100, 27, 3, s, seed=20)
        ms_k = cuda_ms(lambda: ck.fused_chain_walk(5, tables, init, 3), it_k)
        ms_r = cuda_ms(lambda: ck.fused_chain_walk_reference(5, tables, init, 3),
                       it_r)
        bound, by = walk_bound_ms(100, 27, 3, s)
        log("kernel", f"{label}: {27 * s} chains x 100 steps: kernel "
            f"{ms_k:.4f} ms, plain {ms_r:.3f} ms, bound {bound:.4f} ms ({by})")
        rec[label] = dict(ms=ms_k, plain_ms=ms_r, bound_ms=bound, bound_by=by)
    rec["max_abs_err"] = max_err
    return rec


def random_step_inputs(g, n, b, seed):
    rng = np.random.default_rng(seed)
    table = rng.uniform(0.05, 0.95, (g, n)).astype(np.float32)
    rows = rng.integers(0, g, b).astype(np.int32)
    return torch.from_numpy(table).cuda(), torch.from_numpy(rows).cuda()


def phase_step(ck) -> dict:
    """Step kernel vs plain version on the card; returns the timing record."""
    shapes = [(50 * 27 * 8, 3, 6_750_000), (216, 3, 1237),
              (3**7 * 2**7, 7, 1_000_000)]
    max_err = 0.0
    for i, (g, n, b) in enumerate(shapes):
        table, rows = random_step_inputs(g, n, b, seed=30 + i)
        seed = 0x0DDC_0FFE_E123 + i
        out_k = ck.fused_chain_step(seed, table, rows, n, step=7)
        out_r = ck.fused_chain_step_reference(seed, table, rows, n, step=7)
        again = ck.fused_chain_step(seed, table, rows, n, step=7)
        other = ck.fused_chain_step(seed, table, rows, n, step=8)
        torch.cuda.synchronize()
        max_err = max(max_err, float((out_k - out_r).abs().max()))
        check(torch.equal(out_k, out_r),
              f"step kernel == plain bit for bit at G={g} N={n} B={b}")
        check(torch.equal(out_k, again), f"same seed and step repeat at B={b}")
        check(not torch.equal(out_k, other), f"another step differs at B={b}")
        log("step", f"G={g} N={n} B={b}: kernel == plain (bit for bit), "
            "repeatable, another step differs")

    b = 100_000
    for n in (3, 7):
        g = 2**n
        table, _ = random_step_inputs(1, n, 1, seed=40 + n)
        rows = torch.zeros(b, dtype=torch.int32, device="cuda")
        idx = ck.fused_chain_step(99, table, rows, n, step=3)
        y = ((torch.arange(g, device="cuda")[:, None]
              >> torch.arange(n, device="cuda")) & 1).double()
        p1 = table[0].double()
        exact = (p1 * y + (1 - p1) * (1 - y)).prod(-1)[None]  # [1, g]
        tv = tv_rows(idx[None], exact)
        bound = 4 * math.sqrt(g / (2 * math.pi * b))
        check(bool((tv < bound).all()), f"one-row TV {float(tv)} < {bound} "
              f"at N={n}")
        log("step", f"one row, {b} chains, N={n}: TV vs product Bernoulli "
            f"{float(tv):.5f} < bound {bound:.5f}")

    rec = {}
    for label, (g, n, b), it_k, it_r in (("eval", shapes[0], 50, 3),
                                         ("n7", shapes[2], 50, 3)):
        table, rows = random_step_inputs(g, n, b, seed=50)
        ms_k = cuda_ms(lambda: ck.fused_chain_step(5, table, rows, n, 1), it_k)
        ms_r = cuda_ms(
            lambda: ck.fused_chain_step_reference(5, table, rows, n, 1), it_r)
        bound, by = step_bound_ms(b, n, g)
        log("step", f"{label}: G={g} N={n} B={b}: kernel {ms_k:.4f} ms, "
            f"plain {ms_r:.3f} ms, bound {bound:.4f} ms ({by})")
        rec[label] = dict(ms=ms_k, plain_ms=ms_r, bound_ms=bound, bound_by=by)
    rec["max_abs_err"] = max_err
    return rec


def phase_seq_walk(ck, model) -> None:
    """sample_all_bases below 32·6^N chains takes the per-step 'seq' walk,
    which must launch the step kernel once per step and the walk never."""
    from ddqst_tpu_torch.ops import diffusion as diff
    from ddqst_tpu_torch.ops.schedules import make_schedule

    sched = make_schedule("cosine", 100, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    step0, walk0 = ck.fused_chain_step.launches, ck.fused_chain_walk.launches
    out = diff.sample_all_bases(gen, model, 3, 200, sched)
    torch.cuda.synchronize()
    d_step = ck.fused_chain_step.launches - step0
    d_walk = ck.fused_chain_walk.launches - walk0
    log("step", f"sample_all_bases, 200 shots ('seq' walk): step launches "
        f"+{d_step}, walk launches +{d_walk}")
    check(tuple(out.shape) == (27, 200, 3) and out.is_cuda,
          "'seq' samples [27, 200, 3] on the card")
    check(d_step == 100 and d_walk == 0,
          "the 'seq' walk launched the step kernel once per step")


def phase_main_path(ck) -> tuple[int, dict]:
    from ddqst_tpu_torch.config import get_preset
    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.ops import diffusion as diff
    from ddqst_tpu_torch.ops import pauli
    from ddqst_tpu_torch.ops import metrics as M
    from ddqst_tpu_torch.ops.schedules import make_schedule
    from ddqst_tpu_torch.pipeline import run_experiment

    cfg = get_preset("rqc")
    ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
    t0 = time.perf_counter()
    res = run_experiment(cfg, seed=0, log_fn=lambda m: log("main", m))
    wall = time.perf_counter() - t0
    launches = ck.fused_chain_walk.launches
    step_launches = ck.fused_chain_step.launches
    tm = res["timings"]
    log("main", f"wall {wall:.2f} s; stages (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in tm.items()))
    log("main", f"train: {res['train_steps']} steps, "
        f"{res['train_steps'] / tm['train']:.1f} steps/s")
    log("main", f"fidelity {res['fidelity']:.5f} raw_fidelity "
        f"{res['raw_fidelity']:.5f} trace_distance {res['trace_distance']:.5f}"
        f" purity {res['purity']:.5f}")
    log("main", f"fused_chain_walk.launches = {launches}, "
        f"fused_chain_step.launches = {step_launches}")
    check(launches >= 1, "the main path launched the CUDA walk")
    check(step_launches == 0, "run_experiment takes the walk, not the step")

    rho = res["rho"]
    check(rho.shape == (8, 8), "rho is 8x8")
    check(abs(np.trace(rho) - 1) < 1e-4, "trace(rho) == 1 within 1e-4")
    check(np.abs(rho - rho.conj().T).max() < 1e-5, "rho Hermitian within 1e-5")
    check(np.linalg.eigvalsh(rho).min() > -1e-5, "rho PSD within 1e-5")
    for k in ("fidelity", "raw_fidelity", "trace_distance", "purity"):
        check(math.isfinite(res[k]), f"{k} finite")
    samples = res["samples"]
    check(tuple(samples.shape) == (27, cfg.data.shots_infer, 3)
          and samples.is_cuda, "samples [27, 5000, 3] on the card")

    # The samples against the exact chain distribution of the model's own
    # tables, and the fidelity against the inversion of that distribution.
    model = res["state"]
    sched = make_schedule("cosine", cfg.diffusion.num_timesteps, "cuda")
    tables = diff.grid_p1_tables(model, 3, sched).reshape(100, 27, 8, 3)
    exact = exact_walk(tables, torch.full((27, 8), 1 / 8, device="cuda"))
    idx = (samples.long() * (1 << torch.arange(3, device="cuda"))).sum(-1)
    tv = tv_rows(idx, exact)
    bound = 4 * math.sqrt(8 / (2 * math.pi * cfg.data.shots_infer))
    check(bool((tv < bound).all()), f"samples TV {float(tv.max())} < {bound}")
    rho_exact = pauli.make_counts_inverter(3)(
        (exact * cfg.data.shots_infer).float())
    target = torch.from_numpy(res["target"]).cuda()
    fid_exact = float(M.state_fidelity(target, rho_exact))
    log("main", f"samples vs exact chain: max TV {float(tv.max()):.5f} < "
        f"{bound:.5f}; fidelity {res['fidelity']:.5f} vs exact-chain "
        f"inversion {fid_exact:.5f}")
    check(abs(res["fidelity"] - fid_exact) < 0.02,
          "fidelity within 0.02 of the exact-chain inversion")

    cpu_model = build_model(cfg.model, 3, cfg.diffusion.num_timesteps)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_tables = diff.grid_p1_tables(cpu_model.eval(), 3, sched.to("cpu"))
    tab_err = float((tables.reshape(100, 216, 3).cpu() - cpu_tables).abs().max())
    log("main", f"grid tables card vs CPU: max abs err {tab_err:.2e}")
    check(tab_err < 1e-5, "grid tables on the card match the CPU's")
    return launches, res


def check_rho(rho: torch.Tensor, what: str) -> None:
    rho = rho.detach().cpu().numpy()
    check(abs(np.trace(rho) - 1) < 1e-4, f"{what}: trace 1 within 1e-4")
    check(np.abs(rho - rho.conj().T).max() < 1e-5, f"{what}: Hermitian")
    check(np.linalg.eigvalsh(rho).min() > -1e-5, f"{what}: PSD within 1e-5")


def phase_route(ck) -> int:
    """The phase-4 dataset route on the card; returns the step launches of
    the circuit-conditioned evaluation."""
    import dataclasses

    from ddqst_tpu_torch import evaluate as ev
    from ddqst_tpu_torch import pipeline
    from ddqst_tpu_torch.config import get_preset
    from ddqst_tpu_torch.data.generate import build_dataset_chunked
    from ddqst_tpu_torch.data.records import load_dataset
    from ddqst_tpu_torch.ops import diffusion as diff
    from ddqst_tpu_torch.ops import metrics as M
    from ddqst_tpu_torch.ops import pauli
    from ddqst_tpu_torch.ops.schedules import make_schedule
    from ddqst_tpu_torch.utils.logging import write_metrics_csv

    c, n, t_steps, shots = 50, 3, 100, 5000
    base = get_preset("rqc")
    cfg = base.replace(
        model=dataclasses.replace(base.model, condition_on_circuit=True),
        train=dataclasses.replace(base.train, num_epochs=1),
        data=dataclasses.replace(base.data, shots_infer=shots),
    )
    tm = {}
    with tempfile.TemporaryDirectory() as tmp:
        ds, exp = os.path.join(tmp, "ds"), os.path.join(tmp, "exp")
        gen_kw = dict(seed=0, num_samples=c, num_qubits=n, out_dir=ds,
                      chunk_size=25, shots=1024, noise_type="torino",
                      max_bases=50, log_fn=lambda m: log("route", m))
        t0 = time.perf_counter()
        paths = build_dataset_chunked(**gen_kw)
        torch.cuda.synchronize()
        tm["generate"] = time.perf_counter() - t0
        check(len(paths) == 2, "two shards written")
        check(len(build_dataset_chunked(**gen_kw)) == 2,
              "a second build adds no shard")
        records = load_dataset(ds)
        check(len(records) == c and len({r.hash for r in records}) == c,
              "50 unique circuits")

        t0 = time.perf_counter()
        model, eval_recs = pipeline.train_on_dataset(
            cfg, records, save_dir=exp, run_name="route",
            num_eval_circuits=c, seed=0, log_fn=lambda m: log("route", m))
        torch.cuda.synchronize()
        tm["train"] = time.perf_counter() - t0
        check(os.path.exists(os.path.join(exp, "route_eval.npz"))
              and os.path.exists(os.path.join(exp, "route_params.pt")),
              "train_on_dataset wrote its eval subset and params")

        sched = make_schedule("cosine", t_steps, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        extras: dict = {}
        ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
        t0 = time.perf_counter()
        out = ev.evaluate_dataset(
            gen, eval_recs, model, n, sched, shots_infer=shots,
            circuit_conditioned=True, out_dir=None, extras=extras,
            log_fn=lambda m: None)
        torch.cuda.synchronize()
        tm["evaluate"] = time.perf_counter() - t0
        step_launches = ck.fused_chain_step.launches
        walk_launches = ck.fused_chain_walk.launches
        csv_path = os.path.join(exp, "metrics.csv")
        write_metrics_csv(csv_path, out)
        with open(csv_path) as f:
            check(len(f.read().splitlines()) == c + 1, "metrics.csv rows")

    raw = np.array([r["raw_fidelity"] for r in out])
    d3pm = np.array([r["d3pm_fidelity"] for r in out])
    log("route", "stages (s): " + ", ".join(f"{k} {v:.4f}"
                                            for k, v in tm.items()))
    steps = c * 27 * 1024 // cfg.train.batch_size
    log("route", f"train: {steps} steps, {steps / tm['train']:.1f} steps/s")
    log("route", f"mean raw fidelity {raw.mean():.5f}, mean D3PM fidelity "
        f"{d3pm.mean():.5f} over {c} circuits")
    log("route", f"fused_chain_step.launches = {step_launches}, "
        f"fused_chain_walk.launches = {walk_launches}")
    check(step_launches == t_steps and walk_launches == 0,
          "evaluate launched the step kernel once per step and no walk")

    # The samples against the exact chain distribution of the model's own
    # tables, per (circuit, basis) row.
    samples = extras["samples"]
    check(tuple(samples.shape) == (c, 27, shots, n) and samples.is_cuda,
          "samples [50, 27, 5000, 3] on the card")
    t0 = time.perf_counter()
    tables = diff.grid_p1_tables(model, n, sched, num_circuits=c)
    torch.cuda.synchronize()
    t_tables = time.perf_counter() - t0
    packed = torch.stack([
        torch.arange(27, device="cuda").repeat_interleave(shots).repeat(c),
        torch.arange(c, device="cuda").repeat_interleave(27 * shots)], -1)
    t0 = time.perf_counter()
    diff.p_sample_grid(torch.Generator(device="cuda").manual_seed(1), model,
                       packed, n, sched, num_circuits=c)
    torch.cuda.synchronize()
    t_sample = time.perf_counter() - t0
    log("route", f"evaluate's sampling alone: {t_sample:.4f} s, of which the "
        f"table precompute {t_tables:.4f} s; reconstruction and metrics of "
        f"{c} circuits take the rest of {tm['evaluate']:.4f} s")
    tables = tables.reshape(t_steps, c * 27, 2**n, n)
    exact = exact_walk(tables, torch.full((c * 27, 2**n), 1 / 2**n,
                                          device="cuda"))
    idx = (samples.long() * (1 << torch.arange(n, device="cuda"))).sum(-1)
    tv = tv_rows(idx.reshape(c * 27, shots), exact)
    bound = 4 * math.sqrt(2**n / (2 * math.pi * shots))
    check(bool((tv < bound).all()), f"samples TV {float(tv.max())} < {bound}")

    inv = pauli.make_counts_inverter(n)
    exact = exact.reshape(c, 27, 2**n)
    fid_exact = np.array([
        float(M.state_fidelity(torch.from_numpy(r.clean_state).cuda(),
                               inv((exact[i] * shots).float())))
        for i, r in enumerate(eval_recs)
    ])
    delta = np.abs(d3pm - fid_exact)
    log("route", f"samples vs exact chain: max TV {float(tv.max()):.5f} < "
        f"{bound:.5f} over {c * 27} rows; D3PM fidelity vs exact-chain "
        f"inversion: mean |diff| {delta.mean():.5f}, max {delta.max():.5f}")
    check(delta.mean() < 0.01 and delta.max() < 0.03,
          "D3PM fidelities within 0.01 (mean) / 0.03 (max) of the exact chain")

    raw_cpu = np.array([
        float(M.state_fidelity(
            r.clean_state,
            ev._reconstruct_counts(n, r.basis_labels, r.counts, 0.0)))
        for r in eval_recs
    ])
    err = float(np.abs(raw - raw_cpu).max())
    log("route", f"raw fidelity card vs CPU inversion: max abs err {err:.2e}")
    check(err < 1e-4, "raw fidelities match the CPU's within 1e-4")
    for i in range(c):
        check_rho(extras["rho_raw"][i], f"raw rho {i}")
        check_rho(extras["rho_d3pm"][i], f"D3PM rho {i}")
    log("route", f"all {2 * c} rho: trace 1, Hermitian, PSD")
    return step_launches


def build_all(_build) -> None:
    """Build both kernels at once, one nvcc each."""
    names = ("chain_walk", "chain_step")
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build.build, names))
    for name, (path, seconds) in zip(names, built):
        log("build", f"{name}.cu -> {path} in {seconds:.2f} s")
        with open(f"{path}.log") as f:
            for line in f.read().splitlines():
                if "registers" in line or "smem" in line or "spill" in line:
                    log("build", line.strip())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the port "
              "on a GPU", file=sys.stderr)
        return 2
    try:
        from ddqst_tpu_torch.ops import _build
        from ddqst_tpu_torch.ops import cuda_kernels as ck
    except ImportError as e:
        print(f"chip_smoke: the ddqst_tpu_torch package is missing ({e}); "
              "run from the root of a checkout", file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("setup", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} ({smi})")

    build_all(_build)
    kernel = phase_kernel(ck)
    launches, res = phase_main_path(ck)
    step = phase_step(ck)
    phase_seq_walk(ck, res["state"])
    step_launches = phase_route(ck)

    main_rec = kernel["main"]
    eval_rec = step["eval"]
    print(json.dumps({"kernels": [{
        "name": "fused_chain_walk",
        "route": "cuda",
        "source": "ddqst_tpu_torch/csrc/chain_walk.cu",
        "replaces": "ddqst_tpu/ops/pallas_kernels.py:158",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": main_rec["ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": None,
        "ms_1e6_chains": kernel["1e6"]["ms"],
        "plain_ms_1e6_chains": kernel["1e6"]["plain_ms"],
        "bound_ms_1e6_chains": kernel["1e6"]["bound_ms"],
    }, {
        "name": "fused_chain_step",
        "route": "cuda",
        "source": "ddqst_tpu_torch/csrc/chain_step.cu",
        "replaces": "ddqst_tpu/ops/pallas_kernels.py:71",
        "launches": step_launches,
        "max_abs_err": step["max_abs_err"],
        "ms": eval_rec["ms"],
        "plain_ms": eval_rec["plain_ms"],
        "bound_ms": eval_rec["bound_ms"],
        "bound_by": eval_rec["bound_by"],
        "library_ms": None,
        "ms_n7": step["n7"]["ms"],
        "plain_ms_n7": step["n7"]["plain_ms"],
        "bound_ms_n7": step["n7"]["bound_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
