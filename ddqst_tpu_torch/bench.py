"""The port's benchmark harness, the counterpart of the JAX package's
``bench.py``, on one CUDA card.

    python -m ddqst_tpu_torch.bench [--device cuda] [--depth EPOCHS STEPS]
                                    [--ghz-seeds K] [--skip-quality]

It measures what ``bench.py`` measures, at its sizes:

1. training steps/s on the ``rqc`` flagship (FiLM 128 / 512 / 4 blocks,
   N=3, T=100, batch 1,024): 40 steps an epoch on seeded random bits and
   bases, one warm epoch, then 3 repeats of 5 epochs of ``train._run_epoch``;
2. sampled bitstrings/s through ``diffusion.sample_all_bases`` (tables and
   walk) on the trained model at 27 x 5,000 chains, 3 repeats;
3. the same call with the CUDA walk demanded at 27 x 37,037 (about 10^6)
   chains, 5 repeats;
4. the ``shadow_transformer`` preset's (N=10) table sampler
   ``diffusion.sample_for_bases_tables`` at 50 seeded bases x 2,000 shots,
   3 repeats;
5. the GHZ-3 fidelity (the minimum over seeds 0-2) and the RQC-3 fidelity
   (seed 0) of the bench recipes through ``pipeline.run_experiment``.

Every throughput is the median over in-process repeats, its minimum
beside it; each repeat ends with the device synchronised before the clock
stops. The first call of each part, which on the card also builds the CUDA
kernels, is never timed, and neither is a last call that splits a
sampler's time into tables and walk. A part that raises ends the run:
nothing is caught, and there is no CPU fallback.

Output: one JSON object a line. The last is the record, with every key of
``bench.py``'s record under the same meaning, and ``device``: the card's
name and power limit as ``nvidia-smi`` gives them, torch's and CUDA's
versions. The lines before it hold each part's numbers unrounded (its
repeats, its kernel launches, its stage split, its peak memory) and each
recipe run's stage seconds. ``--depth`` and ``--ghz-seeds`` only cut the
quality part's size (defaults: ``bench.py``'s 300 epochs, 800 distillation
steps, 3 seeds), and each cut is printed; ``--skip-quality`` leaves the
quality part out and the record marks its keys null.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from typing import Callable

import numpy as np
import torch

from ddqst_tpu_torch import pipeline, train
from ddqst_tpu_torch.config import get_preset
from ddqst_tpu_torch.device import resolve_device, synchronize
from ddqst_tpu_torch.models import build_model
from ddqst_tpu_torch.models.d3pm import init_params_
from ddqst_tpu_torch.ops import cuda_kernels, diffusion
from ddqst_tpu_torch.ops.schedules import make_schedule

# The reference's baselines (bench.py:24-25): its PyTorch training step
# (batch 1,024) and its T=100 exact-posterior sampler, timed on its host's
# CPU (the reference is CPU PyTorch with no accelerator code), not on any
# card.
TORCH_CPU_TRAIN_STEPS_PER_SEC = 3.5566
TORCH_CPU_SAMPLED_BITSTRINGS_PER_SEC = 140.6
GHZ3_FIDELITY_REFERENCE = 0.87092  # notes.pdf Table 3 (bench.py:268)

# bench.py's sizes: steps an epoch, epochs a repeat and repeats of the
# training part; shots a basis and repeats of the sampling parts; the shadow
# part's bases, shots, repeats and table chunk (2^20 rows, 20 timesteps a
# chunk at 50 x 1,024 rows a timestep); the recipes' depth and GHZ-3 seeds.
TRAIN_STEPS_PER_EPOCH, TRAIN_EPOCHS, TRAIN_REPEATS = 40, 5, 3
SAMPLING_SHOTS, SAMPLING_REPEATS = 5000, 3
WALK_SHOTS, WALK_REPEATS = 37037, 5  # 27 x 37,037 = 1.0e6 chains
SHADOW_BASES, SHADOW_SHOTS, SHADOW_REPEATS = 50, 2000, 3
SHADOW_MAX_TABLE_ROWS = 1 << 20
FULL_DEPTH = (300, 800)
GHZ_SEEDS = 3


def bench_recipe(kind: str, epochs: int, chain_steps: int):
    """The reference bench's GHZ-3 (``kind='ghz'``) or RQC-3 (``'rqc'``)
    end-to-end recipe (``bench.py:182-237``) on the ``rqc`` preset's model,
    at the given depth (CE epochs, distillation steps)."""
    base = get_preset("rqc")
    return base.replace(
        name=f"bench_{kind}3",
        diffusion=type(base.diffusion)(
            num_timesteps=100, schedule="cosine", sampler="renoise"),
        train=type(base.train)(
            batch_size=1024, learning_rate=1e-3, optimizer="adam",
            num_epochs=epochs, lr_schedule="cosine", log_every=0,
            eval_every=0, chain_finetune_steps=chain_steps, chain_lr=3e-4,
            chain_val_fraction=0.15,
            chain_target="mle" if kind == "rqc" else "counts"),
        data=type(base.data)(
            num_qubits=3, state_type=kind, noise_type="readout",
            shots_train=20000 if kind == "rqc" else 5000, shots_infer=50000,
            mitigate_readout=True, mitigate_train_data=True,
            reconstruction="mle"),
    )


def _throughput(fn: Callable[[], object], work: float, repeats: int,
                device: torch.device) -> tuple[float, float, list[float]]:
    """``work`` over the seconds of each of ``repeats`` calls of ``fn``
    (already warm), the device synchronised before the clock stops:
    (median, min, all)."""
    tps = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        tps.append(work / (time.perf_counter() - t0))
    return statistics.median(tps), min(tps), tps


def _launches() -> tuple[int, int]:
    return (cuda_kernels.fused_chain_walk.launches,
            cuda_kernels.fused_chain_step.launches)


class _Part:
    """Within the block, the kernels' launches and the peak memory
    allocated on ``device`` (None on the CPU), added to ``rec``."""

    def __init__(self, device: torch.device, rec: dict):
        self.device, self.rec = device, rec

    def __enter__(self):
        self.before = _launches()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        return self.rec

    def __exit__(self, *exc):
        walks, steps = (a - b for a, b in zip(_launches(), self.before))
        self.rec.update(walk_launches=walks, step_launches=steps,
                        peak_gb=torch.cuda.max_memory_allocated(self.device)
                        / 1e9 if self.device.type == "cuda" else None)


def measure_train_rate(cfg, device: torch.device, steps_per_epoch: int,
                       epochs: int, repeats: int
                       ) -> tuple[dict, torch.nn.Module]:
    """Training steps/s at ``cfg``'s width: ``steps_per_epoch`` batches of
    bits and bases drawn by ``np.random.default_rng(0)``, a seeded model and
    Adam at the preset's constant rate (``bench.py`` builds its optimiser
    with no step total), one warm epoch, then ``repeats`` of ``epochs``
    epochs. Returns the record and the trained model."""
    n, t_steps = cfg.data.num_qubits, cfg.diffusion.num_timesteps
    batch = cfg.train.batch_size
    sched = make_schedule(cfg.diffusion.schedule, t_steps, device)
    gen = torch.Generator(device=device).manual_seed(0)
    model = build_model(cfg.model, n, t_steps).to(device)
    init_params_(model, gen)
    rng = np.random.default_rng(0)
    m = batch * steps_per_epoch
    bits = torch.from_numpy(rng.integers(0, 2, (m, n)).astype(np.int8))
    basis = torch.from_numpy(rng.integers(0, 3**n, (m,)))
    bits, basis = bits.to(device), basis.to(device)
    opt = train.make_optimizer(cfg.train, model.parameters())
    lr_fn = train.make_lr_schedule(cfg.train)
    step = 0
    losses = []

    def epoch() -> None:
        nonlocal step
        loss, k = train._run_epoch(model, opt, lr_fn, step, gen, bits, basis,
                                   sched, batch)
        step += k
        losses.append(loss)

    rec: dict = dict(steps_per_epoch=steps_per_epoch, epochs=epochs,
                     batch=batch)
    model.train()
    with _Part(device, rec):
        epoch()  # warm
        synchronize(device)

        def rep() -> None:
            for _ in range(epochs):
                epoch()

        med, low, reps = _throughput(rep, steps_per_epoch * epochs, repeats,
                                     device)
    model.eval()
    last = float(losses[-1])
    if not np.isfinite(last):
        raise FloatingPointError(f"training loss {last}")
    rec.update(per_sec=med, per_sec_min=low, per_sec_repeats=reps,
               steps=step, last_loss=last)
    return rec, model


def _measure_sampler(device: torch.device,
                     call: Callable[[torch.Generator, dict | None], object],
                     work: int, repeats: int, seeds: tuple[int, int]) -> dict:
    """A warm call (generator seeded ``seeds[0]``), ``repeats`` timed calls
    (one generator seeded ``seeds[1]``), then one untimed call that records
    the split into tables and walk."""
    rec: dict = dict(work=work, repeats=repeats, calls=repeats + 2)
    with _Part(device, rec):
        call(torch.Generator(device=device).manual_seed(seeds[0]), None)
        synchronize(device)
        gen = torch.Generator(device=device).manual_seed(seeds[1])
        med, low, reps = _throughput(lambda: call(gen, None), work, repeats,
                                     device)
        split: dict = {}
        call(gen, split)
    rec.update(per_sec=med, per_sec_min=low, per_sec_repeats=reps,
               timings=split, plan=list(cuda_kernels.fused_chain_walk.last_plan)
               if rec["walk_launches"] else None)
    return rec


def measure_sampling(model: torch.nn.Module, cfg, device: torch.device,
                     shots: int, repeats: int, walk: str = "auto",
                     seeds: tuple[int, int] = (100, 101)) -> dict:
    """Sampled bitstrings/s of ``sample_all_bases`` on ``model`` at
    ``shots`` a basis (tables and walk, end to end)."""
    n = cfg.data.num_qubits
    sched = make_schedule(cfg.diffusion.schedule, cfg.diffusion.num_timesteps,
                          device)

    def call(gen, timings):
        return diffusion.sample_all_bases(gen, model, n, shots, sched,
                                          walk=walk, device=device,
                                          timings=timings)

    return dict(_measure_sampler(device, call, 3**n * shots, repeats, seeds),
                shots=shots, walk=walk)


def measure_walk_1m(model: torch.nn.Module, cfg, device: torch.device,
                    shots: int, repeats: int) -> dict:
    """``measure_sampling`` at about 10^6 chains with the CUDA walk demanded
    (``bench.py``'s ``walk='pallas'``), which raises rather than fall back;
    on the CPU the walk's plain version ('auto')."""
    return measure_sampling(model, cfg, device, shots, repeats,
                            walk="cuda" if device.type == "cuda" else "auto",
                            seeds=(200, 201))


def measure_shadow(device: torch.device, bases: int, shots: int,
                   repeats: int, max_table_rows: int) -> dict:
    """Sampled bitstrings/s of ``sample_for_bases_tables`` on a seeded
    ``shadow_transformer`` model over ``bases`` label rows drawn by
    ``np.random.default_rng(1)``, ``shots`` a row."""
    cfg = get_preset("shadow_transformer")
    n, t_steps = cfg.data.num_qubits, cfg.diffusion.num_timesteps
    sched = make_schedule(cfg.diffusion.schedule, t_steps, device)
    model = build_model(cfg.model, n, t_steps).to(device)
    init_params_(model, torch.Generator(device=device).manual_seed(300))
    model.eval()
    labels = torch.from_numpy(
        np.random.default_rng(1).integers(0, 3, (bases, n))).to(device)

    def call(gen, timings):
        return diffusion.sample_for_bases_tables(
            gen, model, labels, shots, sched, max_table_rows=max_table_rows,
            device=device, timings=timings)

    return dict(_measure_sampler(device, call, bases * shots, repeats,
                                 (301, 302)),
                num_qubits=n, bases=bases, shots=shots,
                max_table_rows=max_table_rows)


def measure_throughputs(device: torch.device,
                        emit: Callable[[dict], None]) -> dict:
    """Parts 1-4 at this module's sizes, each record emitted as it ends."""
    rqc = get_preset("rqc")
    parts = {}
    parts["train"], model = measure_train_rate(
        rqc, device, TRAIN_STEPS_PER_EPOCH, TRAIN_EPOCHS, TRAIN_REPEATS)
    emit({"train": parts["train"]})
    parts["sampling"] = measure_sampling(model, rqc, device, SAMPLING_SHOTS,
                                         SAMPLING_REPEATS)
    emit({"sampling": parts["sampling"]})
    parts["walk_1m"] = measure_walk_1m(model, rqc, device, WALK_SHOTS,
                                       WALK_REPEATS)
    emit({"walk_1m": parts["walk_1m"]})
    parts["shadow"] = measure_shadow(device, SHADOW_BASES, SHADOW_SHOTS,
                                     SHADOW_REPEATS, SHADOW_MAX_TABLE_ROWS)
    emit({"shadow": parts["shadow"]})
    return parts


def measure_quality(device: torch.device, depth: tuple[int, int],
                    ghz_seeds: int, emit: Callable[[dict], None]
                    ) -> list[dict]:
    """GHZ-3 at seeds 0 to ``ghz_seeds``-1, then RQC-3 at seed 0, each one
    ``run_experiment`` of ``bench_recipe`` at ``depth``."""
    runs = []
    for kind, seed in [("ghz", s) for s in range(ghz_seeds)] + [("rqc", 0)]:
        t0 = time.perf_counter()
        res = pipeline.run_experiment(bench_recipe(kind, *depth), seed=seed,
                                      log_fn=lambda m: None, device=device)
        runs.append(dict(
            kind=kind, seed=seed, fidelity=res["fidelity"],
            raw_fidelity=res["raw_fidelity"],
            raw_fidelity_mitigated=res["raw_fidelity_mitigated"],
            wall_s=time.perf_counter() - t0, timings=res["timings"],
            train_steps=res["train_steps"],
            distill_steps=len(res.get("ft_losses", ())),
            best_step=res.get("chain_info", {}).get("best_step")))
        emit({"recipe": runs[-1]})
    return runs


def _r5(x):
    return None if x is None else round(x, 5)


def quality_keys(runs: list[dict] | None) -> dict:
    """``bench.py``'s quality keys from recipe runs (dicts with ``kind``,
    ``fidelity``, ``raw_fidelity``, ``raw_fidelity_mitigated``); all null
    when ``runs`` is None."""
    keys = dict(ghz3_fidelity=None, ghz3_fidelity_seeds=None,
                ghz3_raw_fidelity=None, ghz3_mle_fidelity=None,
                ghz3_fidelity_reference=GHZ3_FIDELITY_REFERENCE,
                rqc3_fidelity=None)
    if runs is None:
        return keys
    ghz = [r for r in runs if r["kind"] == "ghz"]
    (rqc,) = [r for r in runs if r["kind"] == "rqc"]
    keys.update(
        # The minimum over the seeds, as bench.py: robust to their spread.
        ghz3_fidelity=_r5(min(r["fidelity"] for r in ghz)),
        ghz3_fidelity_seeds=[_r5(r["fidelity"]) for r in ghz],
        # Plain linear inversion of the raw shots (the reference's).
        ghz3_raw_fidelity=_r5(min(r["raw_fidelity"] for r in ghz)),
        # Noise-aware MLE on the raw shots.
        ghz3_mle_fidelity=_r5(min(r["raw_fidelity_mitigated"] for r in ghz)),
        rqc3_fidelity=_r5(rqc["fidelity"]))
    return keys


def device_info(device: torch.device) -> dict:
    """The device a record was measured on: on a card its name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit`` prints them."""
    info = dict(type=device.type, torch=torch.__version__,
                cuda=torch.version.cuda)
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
        info.update(name=torch.cuda.get_device_name(device),
                    nvidia_smi=smi[device.index])
    return info


def make_record(parts: dict, quality: dict, device: dict) -> dict:
    """The record: ``bench.py``'s keys (rounded as it rounds them), from the
    parts of ``measure_throughputs`` and ``quality_keys``."""
    tr, sa, wk, sh = (parts[k] for k in ("train", "sampling", "walk_1m",
                                        "shadow"))
    return {
        "metric": "train_steps_per_sec",
        "value": round(tr["per_sec"], 2),
        "unit": f"steps/s (batch {tr['batch']}, N=3 flagship; median of "
                f"{len(tr['per_sec_repeats'])})",
        "vs_baseline": round(tr["per_sec"] / TORCH_CPU_TRAIN_STEPS_PER_SEC, 2),
        "train_steps_per_sec_min": round(tr["per_sec_min"], 2),
        "sampled_bitstrings_per_sec": round(sa["per_sec"], 1),
        "sampled_bitstrings_per_sec_min": round(sa["per_sec_min"], 1),
        "sampling_vs_baseline": round(
            sa["per_sec"] / TORCH_CPU_SAMPLED_BITSTRINGS_PER_SEC, 2),
        **quality,
        # The name is the reference's (its Pallas walk on a TPU); here it
        # is the CUDA walk, end to end through sample_all_bases.
        "pallas_walk_bitstrings_per_sec": round(wk["per_sec"], 1),
        "pallas_walk_bitstrings_per_sec_min": round(wk["per_sec_min"], 1),
        "pallas_walk_repeats": [round(t, 1) for t in wk["per_sec_repeats"]],
        "shadow_transformer_bitstrings_per_sec": round(sh["per_sec"], 1),
        "shadow_transformer_bitstrings_per_sec_min": round(
            sh["per_sec_min"], 1),
        "device": device,
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m ddqst_tpu_torch.bench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without one)")
    p.add_argument("--depth", nargs=2, type=int, default=list(FULL_DEPTH),
                   metavar=("EPOCHS", "STEPS"),
                   help="the recipes' CE epochs and distillation steps")
    p.add_argument("--ghz-seeds", type=int, default=GHZ_SEEDS,
                   help="GHZ-3 runs, at seeds 0 to K-1")
    p.add_argument("--skip-quality", action="store_true",
                   help="leave the recipes out; their keys are null")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    def emit(obj: dict) -> None:
        print(json.dumps(obj), flush=True)

    depth = tuple(args.depth)
    for what, got, full in (("num_epochs", depth[0], FULL_DEPTH[0]),
                            ("chain_finetune_steps", depth[1], FULL_DEPTH[1]),
                            ("ghz_seeds", args.ghz_seeds, GHZ_SEEDS)):
        if got != full and not args.skip_quality:
            emit({"cut": f"{what} {full} -> {got}"})
    info = device_info(device)
    parts = measure_throughputs(device, emit)
    if args.skip_quality:
        runs, note = None, "skipped (--skip-quality)"
    else:
        runs = measure_quality(device, depth, args.ghz_seeds, emit)
        note = dict(epochs=depth[0], chain_steps=depth[1],
                    ghz_seeds=args.ghz_seeds)
    emit(dict(make_record(parts, quality_keys(runs), info), quality=note))
    return 0


if __name__ == "__main__":
    sys.exit(main())
