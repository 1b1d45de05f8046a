#!/usr/bin/env python3
"""Drive the PyTorch port (``ddqst_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
result line is printed; nothing falls back to the CPU):

1. build  — compile ``ddqst_tpu_torch/csrc/chain_walk.cu`` with nvcc for
   sm_90a from the sources in this checkout, and print the build time and
   the compiler's register / shared-memory report;
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
   exact distribution, and that the tables on the card match the CPU's.

Then it prints the kernel table as one JSON line, the card's name and power
limit as ``nvidia-smi`` gives them, and, last, the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

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


def phase_main_path(ck) -> tuple[int, dict]:
    from ddqst_tpu_torch.config import get_preset
    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.ops import diffusion as diff
    from ddqst_tpu_torch.ops import pauli
    from ddqst_tpu_torch.ops import metrics as M
    from ddqst_tpu_torch.ops.schedules import make_schedule
    from ddqst_tpu_torch.pipeline import run_experiment

    cfg = get_preset("rqc")
    ck.fused_chain_walk.launches = 0
    t0 = time.perf_counter()
    res = run_experiment(cfg, seed=0, log_fn=lambda m: log("main", m))
    wall = time.perf_counter() - t0
    launches = ck.fused_chain_walk.launches
    tm = res["timings"]
    log("main", f"wall {wall:.2f} s; stages (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in tm.items()))
    log("main", f"train: {res['train_steps']} steps, "
        f"{res['train_steps'] / tm['train']:.1f} steps/s")
    log("main", f"fidelity {res['fidelity']:.5f} raw_fidelity "
        f"{res['raw_fidelity']:.5f} trace_distance {res['trace_distance']:.5f}"
        f" purity {res['purity']:.5f}")
    log("main", f"fused_chain_walk.launches = {launches}")
    check(launches >= 1, "the main path launched the CUDA walk")

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

    path, seconds = _build.build("chain_walk")
    log("build", f"chain_walk.cu -> {path} in {seconds:.2f} s")
    with open(f"{path}.log") as f:
        for line in f.read().splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log("build", line.strip())

    kernel = phase_kernel(ck)
    launches, _ = phase_main_path(ck)

    main_rec = kernel["main"]
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
