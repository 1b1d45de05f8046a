"""End-to-end tomography pipeline: generate → train → sample → reconstruct.

The port's counterpart of ``ddqst_tpu/pipeline.py``. ``run_experiment`` is
the full route; in generate mode:

1. simulate shots in all 3^N bases (:func:`generate_training_data`);
2. train the denoiser on the denoising cross-entropy (``train.fit``);
3. optionally distil the sampler's exact output distribution onto the
   training counts, or onto the Born probabilities of their MLE
   (``train.finetune_chain``), with a held-out split choosing the step;
4. build the grid probability tables in one batched forward, and
5. walk the chains (on CUDA, the hand-written kernel) —
   ``ops.diffusion.sample_all_bases``;
6. histogram the samples (``ops.mle.bits_to_counts``);
7. reconstruct by linear inversion (``ops.pauli.make_counts_inverter``) or
   maximum likelihood (``ops.mle.make_mle``);
8. compute the metrics (``ops.metrics``), plus the reference's control:
   linear inversion of the raw training shots.

In denoise mode (``infer_mode='denoise'``) steps 3-5 become one: the
measured shots, tiled to cover ``shots_infer``, are reverse-diffused from
the step t* matched to the readout flip rate
(``ops.diffusion.denoise_dataset``), and the samples are reconstructed over
the measured bases without readout mitigation.

For ``N > 8``, or ``N >= 7`` with ``max_bases``, ``run_experiment`` takes
the shadow route instead (``_run_shadow_experiment``): a transformer
conditioned on per-qubit basis labels, trained on the sampled bases,
optionally distilled over exactly those bases, generating through
``ops.diffusion.sample_for_bases`` (at ``shots >= 2^N`` the grid tables
and one walk of the CUDA kernel), and scored against the exact Born
probabilities of the clean target per basis (no density matrix). With
``gen_tables_once`` the full route generates through
``ops.diffusion.sample_all_bases_chunked``: the tables once, then walks.

With a mesh (``parallel.mesh.make_mesh``) every rank runs
``run_experiment`` with the same arguments: ``train.fit`` trains data- and
tensor-parallel, and every rank runs the stages after training with the
same generators on the same whole model, so all return the same result.
Only rank 0 logs and writes files.

The data cache keeps the JAX package's npz schema, so each package reads
the other's cache. ``params_load`` / ``params_save`` read and write a
``torch.save`` state dict (``models.convert.params_from_flax`` turns the JAX
package's params into one).

``train_on_dataset`` is the phase-4 dataset route's training step: it
trains one denoiser on a prebuilt circuit dataset (``data.generate``),
optionally conditioned on the circuit, and saves the eval subset and the
params for ``evaluate.evaluate_dataset``. ``create_sanity_records`` is the
memorisation check's synthetic dataset.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ddqst_tpu_torch import train as training
from ddqst_tpu_torch.config import ExperimentConfig
from ddqst_tpu_torch.data.loader import dataset_to_training_arrays
from ddqst_tpu_torch.data.records import CircuitRecord, save_shard
from ddqst_tpu_torch.device import resolve_device, synchronize
from ddqst_tpu_torch.models import build_model
from ddqst_tpu_torch.ops import diffusion as diff
from ddqst_tpu_torch.ops import metrics as M
from ddqst_tpu_torch.ops import mle
from ddqst_tpu_torch.ops import pauli
from ddqst_tpu_torch.ops.mle import bits_to_counts
from ddqst_tpu_torch.ops.schedules import make_schedule
from ddqst_tpu_torch.parallel.mesh import mesh_device
from ddqst_tpu_torch.qsim import measure, noise, states
from ddqst_tpu_torch.utils.checkpoint import (
    restore_chain_opt,
    restore_params,
    save_chain_opt,
    save_params,
)

# Max reverse-sampler chains (bases x shots) per sample_all_bases call: the
# JAX package's TPU dispatch bound, kept for parity (not an H100 limit).
_GEN_CHAIN_CAP = 1 << 21


@dataclasses.dataclass
class GeneratedData:
    bits: torch.Tensor         # [B_bases, shots, N] int8
    basis_labels: np.ndarray   # [B_bases, N] int
    basis_idx: np.ndarray      # [B_bases] canonical indices
    target: np.ndarray         # clean statevector [2^N] (fidelity target)
    circuit: states.Circuit | None  # None when restored from a cache
    clean_probs: np.ndarray | None = None  # clean Born probs [B_bases, 2^N]


def noisy_basis_probs(
    circuit: states.Circuit, ncfg: noise.NoiseConfig, rots: torch.Tensor,
) -> torch.Tensor:
    """Outcome probabilities ``[B, 2^N]`` of the noisy state in each basis of
    the ``[B, 2^N, 2^N]`` rotation stack ``rots`` (on the working device),
    readout channel included: what the shots are drawn from."""
    kind, state = noise.noisy_state(circuit, ncfg)
    state = torch.from_numpy(state).to(rots.device)
    if kind == "pure":
        probs = measure.batched_probs_pure(state[None], rots)[0]
    else:
        probs = measure.batched_probs_mixed(state[None], rots)[0]
    return noise.apply_readout_to_probs(probs, circuit.num_qubits,
                                        ncfg.readout_p)


def generate_training_data(
    cfg: ExperimentConfig, generator: torch.Generator, rng: np.random.Generator,
) -> GeneratedData:
    """Simulate per-basis measurement shots for the configured state/noise.

    The circuit and basis selection draw from ``rng`` (numpy, as in the JAX
    package, so one seed gives the same circuit and target); the shots draw
    from ``generator`` on the working device.
    """
    d = cfg.data
    dev = generator.device
    circuit = states.prep_circuit(d.state_type, d.num_qubits, d.rqc_depth, rng)
    target = states.circuit_statevector(circuit)
    ncfg = noise.get_noise_config(d.noise_type)

    all_labels = pauli.all_basis_labels(d.num_qubits)
    if d.max_bases and d.max_bases < len(all_labels):
        sel = rng.choice(len(all_labels), size=d.max_bases, replace=False)
        sel.sort()
    else:
        sel = np.arange(len(all_labels))
    labels = all_labels[sel]
    # One rotation stack for the noisy and the clean probabilities, as the
    # JAX package builds it (3.4 GB at N = 8).
    rots = torch.from_numpy(measure.rotation_unitaries(labels)).to(dev)
    probs = noisy_basis_probs(circuit, ncfg, rots)
    clean_probs = measure.batched_probs_pure(
        torch.from_numpy(target).to(dev)[None], rots
    )[0].cpu().numpy()
    bits = measure.sample_bits(generator, probs, d.shots_train, d.num_qubits)

    if d.mitigate_train_data and ncfg.readout_p > 0:
        # Invert the confusion matrix on the empirical per-basis frequencies,
        # clip negatives, renormalise, and resample the training shots from
        # the cleaned distribution.
        counts = bits_to_counts(bits)
        freqs = counts / counts.sum(dim=-1, keepdim=True)
        m_inv = torch.from_numpy(np.linalg.inv(
            noise.confusion_matrix(d.num_qubits, ncfg.readout_p)
        )).to(dev)
        clean = torch.einsum("ij,bj->bi", m_inv, freqs).clamp_min(0.0)
        clean = clean / clean.sum(dim=-1, keepdim=True)
        bits = measure.sample_bits(generator, clean, d.shots_train,
                                   d.num_qubits)
    return GeneratedData(
        bits=bits,
        basis_labels=labels,
        basis_idx=sel.astype(np.int32),
        target=target,
        circuit=circuit,
        clean_probs=clean_probs,
    )


def save_data_cache(path: str, data: GeneratedData) -> None:
    """Persist a GeneratedData to npz (the JAX package's schema)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # file handle: exact name, atomic rename
        np.savez_compressed(
            f,
            bits=data.bits.cpu().numpy().astype(np.int8),
            basis_labels=np.asarray(data.basis_labels),
            basis_idx=np.asarray(data.basis_idx),
            target=np.asarray(data.target),
            clean_probs=(
                np.zeros((0,)) if data.clean_probs is None
                else np.asarray(data.clean_probs)
            ),
        )
    os.replace(tmp, path)


def load_data_cache(path: str, device="cpu") -> GeneratedData:
    """Restore a GeneratedData saved by either package's ``save_data_cache``."""
    with np.load(path) as z:
        clean = z["clean_probs"]
        return GeneratedData(
            bits=torch.from_numpy(z["bits"].astype(np.int8)).to(device),
            basis_labels=z["basis_labels"],
            basis_idx=z["basis_idx"],
            target=z["target"],
            circuit=None,
            clean_probs=None if clean.size == 0 else clean,
        )


def ensure_data_cache(cfg: ExperimentConfig, seed: int, path: str,
                      log_fn: Callable = print,
                      device: str | torch.device | None = None) -> str:
    """Fill a data cache at ``path`` if it is absent; a no-op when it exists.

    The streams are :func:`run_experiment`'s (the data generator of
    ``_generators(seed, device)`` and ``np.random.default_rng(seed)``), so
    the cache holds exactly the data a run with this seed on ``device``
    would have generated itself. Returns ``path``.
    """
    if os.path.exists(path):
        return path
    dev = resolve_device(device)
    g_data, _, _ = _generators(seed, dev)
    log_fn(f"[{cfg.name}] datagen: {cfg.data.state_type} "
           f"N={cfg.data.num_qubits} noise={cfg.data.noise_type} "
           f"shots={cfg.data.shots_train} -> {path}")
    data = generate_training_data(cfg, g_data, np.random.default_rng(seed))
    if not os.path.exists(path):  # another process may have written it
        save_data_cache(path, data)
    return path


def flatten_for_training(
    bits: torch.Tensor, basis_idx: np.ndarray
) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, S, N] shots + [B] indices → [B*S, N] bits, [B*S] basis indices."""
    b, s, n = bits.shape
    basis = torch.from_numpy(np.asarray(basis_idx, np.int64)).to(bits.device)
    return bits.reshape(b * s, n), basis.repeat_interleave(s)


def use_shadow_route(num_qubits: int, max_bases: int | None) -> bool:
    """The JAX package's switch to per-qubit conditioning at large N."""
    return num_qubits > 8 or (num_qubits >= 7 and bool(max_bases))


def _generator(ss: np.random.SeedSequence, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        int(ss.generate_state(1, np.uint64)[0]))


def _generators(seed: int, device: torch.device) -> list[torch.Generator]:
    """Independent data / train / sample generators derived from ``seed``."""
    return [_generator(ss, device)
            for ss in np.random.SeedSequence(seed).spawn(3)]


# Entropy word that separates the distillation minibatch stream from the
# other streams of a seed (the JAX package folds the same constant in).
_DISTILL_STREAM = 0xD157


def _distill(cfg: ExperimentConfig, seed: int, data: GeneratedData,
             model: torch.nn.Module, schedule, dev: torch.device,
             target_cache: str, opt_load: str, opt_save: str,
             timings: dict, mle_iterations: dict, log_fn: Callable,
             shadow: bool = False):
    """Exact-chain distillation of ``model`` against the training counts
    (see ``train.finetune_chain``). Returns ``(losses, info)``.

    ``shadow``: the chain runs over exactly the measured bases, conditioned
    on their ``[B, N]`` labels, and the target is always their counts (the
    JAX package's shadow route reads no ``chain_target``)."""
    n = cfg.data.num_qubits
    tc = cfg.train
    labels = None
    if shadow:
        labels = torch.from_numpy(
            np.asarray(data.basis_labels, np.int64)).to(dev)
        log_fn(f"[{cfg.name}] shadow-scale chain distillation: "
               f"{tc.chain_finetune_steps} steps over {labels.shape[0]} bases")
    else:
        log_fn(f"[{cfg.name}] exact-chain distillation: "
               f"{tc.chain_finetune_steps} steps")
    t0 = time.perf_counter()
    val_counts = None
    if tc.chain_val_fraction > 0:
        # Held-out split at the shot level (shots are iid per basis): the
        # last round(vf·S) shots per basis choose the distillation step,
        # the rest form the target.
        s = data.bits.shape[1]
        s_val = min(max(int(round(tc.chain_val_fraction * s)), 1), s - 1)
        tgt_counts = bits_to_counts(data.bits[:, :s - s_val])
        val_counts = bits_to_counts(data.bits[:, s - s_val:])
    else:
        tgt_counts = bits_to_counts(data.bits)
    if tc.chain_target == "mle" and not shadow:
        # Physics-constrained target: project the training counts through
        # the (PSD, trace-1) MLE manifold and distil against the Born
        # distribution of the estimate, which carries the cross-basis
        # positivity constraint the per-basis counts cannot express.
        # readout_p = 0: the target lives in the domain the chain is
        # matched in. Held-out selection still scores against the actual
        # held-out counts.
        if target_cache and os.path.exists(target_cache):
            with np.load(target_cache) as z:
                tgt_counts = torch.from_numpy(
                    z["target"].astype(np.float32)).to(dev)
            log_fn(f"[{cfg.name}] distillation target: MLE Born probs "
                   f"(cached, {target_cache})")
        else:
            solve: dict = {}
            rho_t = mle.make_mle(n, data.basis_labels)(tgt_counts, solve)
            mle_iterations["target"] = solve["iterations"]
            d = 2**n
            if data.basis_labels.shape[0] * d * d > mle._FACTORED_BLOCK_ELEMS:
                tgt_counts = mle.factored_born_probs(rho_t, data.basis_labels)
            else:
                rots = torch.from_numpy(
                    measure.rotation_unitaries(data.basis_labels)).to(dev)
                tgt_counts = measure.batched_probs_mixed(rho_t[None], rots)[0]
            if target_cache:
                with open(target_cache, "wb") as f:  # exact name
                    np.savez_compressed(f, target=tgt_counts.cpu().numpy())
            log_fn(f"[{cfg.name}] distillation target: MLE Born probs")
    synchronize(dev)
    timings["target"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    init_opt = None
    if opt_load:
        init_opt = restore_chain_opt(opt_load,
                                     training.chain_opt_template(model))
        log_fn(f"chained distillation Adam state from {opt_load}")
    model, ft_losses, info = training.finetune_chain(
        model, tgt_counts, schedule, n,
        steps=tc.chain_finetune_steps,
        learning_rate=tc.chain_lr,
        exact=cfg.diffusion.exact,
        basis_batch=tc.chain_basis_batch,
        generator=_generator(
            np.random.SeedSequence(
                [seed, _DISTILL_STREAM + tc.chain_key_salt]), dev),
        steps_per_call=tc.chain_steps_per_call,
        val_counts=val_counts,
        val_patience=tc.chain_val_patience,
        accum=tc.chain_accum,
        hard_frac=tc.chain_hard_frac,
        init_opt_state=init_opt,
        basis_labels=labels,
        device=dev,
    )
    # The params-sized moments never reach a results dict.
    final_opt = info.pop("final_opt_state")
    if opt_save:
        save_chain_opt(opt_save, final_opt)
        log_fn(f"saved distillation Adam state to {opt_save}")
    synchronize(dev)
    timings["distill"] = time.perf_counter() - t0
    msg = (f"[{cfg.name}] chain CE "
           f"({'all shadow bases' if shadow else 'full grid'}) "
           f"{info['train_ce_before']:.5f} -> {info['train_ce_after']:.5f}")
    if val_counts is not None:
        msg += (f"; held-out best {info['best_val_ce']:.5f} at step "
                f"{info['best_step']} (ran {ft_losses.shape[0]} of "
                f"{tc.chain_finetune_steps})")
    log_fn(msg)
    return ft_losses, info


def run_experiment(
    cfg: ExperimentConfig,
    seed: int = 0,
    mesh=None,
    log_fn: Callable = print,
    params_load: str = "",
    params_save: str = "",
    target_cache: str = "",
    stop_after: str = "",
    opt_load: str = "",
    opt_save: str = "",
    data_cache: str = "",
    device: str | torch.device | None = None,
) -> dict:
    """Full-route run. Returns a metrics dict.

    Keys as in the JAX package: fidelity, raw_fidelity,
    raw_fidelity_mitigated, trace_distance, trace_distance_raw,
    expectations, expectations_raw, purity, vn_entropy, ent_entropy, z_bias,
    losses, rho, rho_raw, target, state (the trained model), samples; plus
    ``timings`` (seconds per stage: datagen, train, with distillation target
    and distill, then tables and walk (generate mode) or denoise (denoise
    mode), inversion, metrics; the device is synchronised at each
    boundary), ``train_steps`` (optimiser steps run in this call),
    ``mle_iterations``
    (updates applied by each MLE solve that ran: ``target``, ``samples``,
    ``raw``) and, after distillation, ``chain_info`` (``train_ce_before`` /
    ``train_ce_after``, and with a held-out split ``val_history``,
    ``best_step``, ``best_val_ce``) and ``ft_losses``.

    Runs on ``device`` (default CUDA; raises if CUDA is absent and
    ``device`` was not given), or with ``mesh`` on the mesh's device, every
    rank with the same arguments (see the module docstring; ``data_cache``
    and ``target_cache`` are read where they exist when the call starts, and
    written by rank 0). ``params_load`` skips CE training and loads a
    ``torch.save`` state dict; ``params_save`` writes one, after
    distillation. ``data_cache`` is an npz path in the JAX package's schema,
    read if it exists and written otherwise.

    ``cfg.train.chain_finetune_steps > 0`` runs exact-chain distillation
    (it needs generate mode and all 3^N bases; otherwise it is skipped with
    a warning). ``cfg.diffusion.infer_mode='denoise'`` reverse-diffuses the
    measured shots instead of generating: t* = ``match_timestep(schedule,
    max(readout_p, 0.01))``, the training shots tiled ``reps =
    max(ceil(shots_infer / shots_train), 1)`` times (samples ``[B_bases,
    reps·S, N]``, each basis' rep 0 first), conditioned on
    ``data.basis_idx``, reconstructed over ``data.basis_labels`` without
    readout mitigation; ``z_bias`` is the Z…Z row's, or None when that
    basis was not measured. ``cfg.train.checkpoint_dir`` /
    ``checkpoint_every`` / ``resume`` reach ``train.fit``.
    ``target_cache`` (``chain_target='mle'``): npz path of the MLE-projected
    Born-probabilities target, read if it exists and written otherwise.
    ``opt_load`` / ``opt_save``: ``torch.save`` paths of the distillation
    Adam moments, to chain them across warm-started segments.
    ``stop_after='distill'`` returns right after distillation and
    ``params_save`` with ``{'losses', 'ft_losses', 'ft_info'}``: a later
    ``params_load`` run with ``chain_finetune_steps=0`` does the generation
    and estimator tail. ``gen_tables_once`` generates through
    ``sample_all_bases_chunked`` (the tables once, then the walks).

    For ``N > 8``, or ``N >= 7`` with ``max_bases`` (``use_shadow_route``),
    the run takes the shadow route after the data step, in either inference
    mode (it never reads ``infer_mode``, as in the JAX package); see
    :func:`_run_shadow_experiment` for its results.
    """
    dev = mesh_device(mesh, device)
    if mesh is not None:
        # Every rank looks for the caches before any rank can write one, so
        # all read the same data; only rank 0 writes and logs.
        data_cache, target_cache = (
            p if mesh.rank == 0 or (p and os.path.exists(p)) else ""
            for p in (data_cache, target_cache))
        dist.barrier()
        if mesh.rank != 0:
            log_fn, params_save, opt_save = training._silent, "", ""
    n = cfg.data.num_qubits
    rng = np.random.default_rng(seed)
    g_data, g_train, g_sample = _generators(seed, dev)
    timings: dict[str, float] = {}

    t0 = time.perf_counter()
    if data_cache and os.path.exists(data_cache):
        log_fn(f"[{cfg.name}] loading cached data from {data_cache}")
        data = load_data_cache(data_cache, dev)
    else:
        log_fn(
            f"[{cfg.name}] generating {cfg.data.state_type} "
            f"N={n} noise={cfg.data.noise_type} shots={cfg.data.shots_train}"
        )
        data = generate_training_data(cfg, g_data, rng)
        if data_cache:
            save_data_cache(data_cache, data)
            log_fn(f"[{cfg.name}] cached data to {data_cache}")
    synchronize(dev)
    timings["datagen"] = time.perf_counter() - t0
    if use_shadow_route(n, cfg.data.max_bases):
        return _run_shadow_experiment(
            cfg, seed, data, dev, g_train, g_sample, timings, log_fn,
            mesh=mesh, params_load=params_load, params_save=params_save,
            stop_after=stop_after, opt_load=opt_load, opt_save=opt_save)

    model = build_model(cfg.model, n, cfg.diffusion.num_timesteps).to(dev)
    schedule = make_schedule(cfg.diffusion.schedule,
                             cfg.diffusion.num_timesteps, dev)
    t0 = time.perf_counter()
    train_steps = 0
    if params_load:
        restore_params(params_load, model).eval()
        losses = torch.zeros(0)
        log_fn(f"[{cfg.name}] warm start: params from {params_load} "
               "(CE training skipped)")
    else:
        x, basis = flatten_for_training(data.bits, data.basis_idx)
        log_fn(f"[{cfg.name}] training on {x.shape[0]} shots")
        model, losses = training.fit(
            g_train, model, x, basis, cfg.train, schedule, mesh=mesh,
            log_fn=log_fn, device=dev,
        )
        train_steps = (max(x.shape[0] // min(cfg.train.batch_size, x.shape[0]), 1)
                       * len(losses))
    synchronize(dev)
    timings["train"] = time.perf_counter() - t0

    denoised = cfg.diffusion.infer_mode == "denoise"
    ft_info = ft_losses = None
    mle_iterations: dict[str, int] = {}
    if cfg.train.chain_finetune_steps > 0:
        if not denoised and len(data.basis_idx) == 3**n:
            ft_losses, ft_info = _distill(
                cfg, seed, data, model, schedule, dev, target_cache,
                opt_load, opt_save, timings, mle_iterations, log_fn)
        else:
            log_fn(f"[{cfg.name}] WARNING: chain distillation skipped (needs "
                   "infer_mode='generate' and the full canonical basis set)")
    if params_save:
        save_params(params_save, model)
        log_fn(f"[{cfg.name}] saved params to {params_save}")
    if stop_after == "distill":
        return _distill_only(losses, ft_losses, ft_info)

    if denoised:
        samples = _denoise_shots(cfg, data, model, schedule, g_sample, dev,
                                 timings, log_fn)
    else:
        samples = _generate(cfg, model, schedule, g_sample, dev, timings,
                            log_fn)

    t0 = time.perf_counter()
    mit_p = 0.0
    if cfg.data.mitigate_readout:
        mit_p = noise.get_noise_config(cfg.data.noise_type).readout_p
    # Samples are already clean when the reverse chain inverted the readout
    # channel (denoise mode) or the model was trained on mitigated data;
    # mitigating them again would over-correct.
    sample_p = 0.0 if denoised or cfg.data.mitigate_train_data else mit_p
    use_mle = cfg.data.reconstruction == "mle"

    def reconstruct(counts, labels, p, what):
        # Counts-native both ways: scatter-add histogram, then the MLE
        # iteration or the WHT parities.
        if use_mle:
            solve: dict = {}
            rho = mle.make_mle(n, labels, readout_p=p)(counts, solve)
            mle_iterations[what] = solve["iterations"]
            return rho
        return pauli.make_counts_inverter(n, labels, readout_p=p)(counts)

    rho = reconstruct(bits_to_counts(samples),
                      data.basis_labels if denoised else None, sample_p,
                      "samples")
    # Baseline: unmitigated linear inversion of the raw training shots,
    # plus the configured estimator where it differs.
    raw_counts = bits_to_counts(data.bits)
    rho_raw = pauli.make_counts_inverter(n, data.basis_labels)(raw_counts)
    rho_raw_mit = None
    if mit_p > 0 or use_mle:
        rho_raw_mit = reconstruct(raw_counts, data.basis_labels, mit_p, "raw")
    synchronize(dev)
    timings["inversion"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if denoised:
        # The Z...Z basis may be missing from the measured set: the
        # diagnostic is then reported as missing, not as its ideal value.
        zz_rows = np.nonzero((np.asarray(data.basis_labels) == 2).all(axis=1))[0]
        zb = float(M.z_bias(samples[int(zz_rows[0])])) if len(zz_rows) else None
    else:
        zb = float(M.z_bias(samples[-1]))  # the last canonical basis is Z...Z
    target = torch.from_numpy(np.asarray(data.target)).to(dev)
    pur, vn, ent = M.get_metrics(rho, n)
    results = {
        "fidelity": float(M.state_fidelity(target, rho)),
        "raw_fidelity": float(M.state_fidelity(target, rho_raw)),
        "raw_fidelity_mitigated": (
            None if rho_raw_mit is None
            else float(M.state_fidelity(target, rho_raw_mit))
        ),
        "trace_distance": float(M.trace_distance(target, rho)),
        "trace_distance_raw": float(M.trace_distance(target, rho_raw)),
        # Single-site ⟨X⟩/⟨Y⟩/⟨Z⟩ per qubit.
        "expectations": M.pauli_expectations(rho),
        "expectations_raw": M.pauli_expectations(rho_raw),
        "purity": float(pur),
        "vn_entropy": float(vn),
        "ent_entropy": float(ent),
        "z_bias": zb,
        "losses": losses.detach().cpu().numpy(),
        "rho": rho.cpu().numpy(),
        "rho_raw": rho_raw.cpu().numpy(),
        "target": np.asarray(data.target),
        "state": model,
        "samples": samples,
        "train_steps": train_steps,
        "timings": timings,
        "mle_iterations": mle_iterations,
    }
    if ft_info is not None:
        results["chain_info"] = ft_info
        results["ft_losses"] = ft_losses.cpu().numpy()
    timings["metrics"] = time.perf_counter() - t0
    log_fn(
        f"[{cfg.name}] fidelity={results['fidelity']:.5f} "
        f"(raw baseline {results['raw_fidelity']:.5f}) "
        f"trace_distance={results['trace_distance']:.5f} "
        f"purity={results['purity']:.5f}"
    )
    threshold = 0.9  # reference success criterion
    ok = results["fidelity"] > threshold
    log_fn(
        f"[{cfg.name}] {'SUCCESS' if ok else 'WARNING'}"
        f": fidelity {'>' if ok else '<='} {threshold}"
    )
    return results


def _denoise_shots(cfg: ExperimentConfig, data: GeneratedData, model,
                   schedule, g_sample: torch.Generator, dev: torch.device,
                   timings: dict, log_fn: Callable) -> torch.Tensor:
    """Denoise mode: reverse-diffuse the measured shots, tiled ``reps``
    times, from the step matched to the readout flip rate. Returns ``[B,
    reps·S, N]`` int8, each basis' rep 0 first; ``timings['denoise']``."""
    ncfg = noise.get_noise_config(cfg.data.noise_type)
    t_star = diff.match_timestep(schedule, max(ncfg.readout_p, 0.01))
    reps = max(-(-cfg.data.shots_infer // cfg.data.shots_train), 1)
    log_fn(f"[{cfg.name}] denoising measured shots x{reps} from t*={t_star}")
    t0 = time.perf_counter()
    b_bases, s, n = data.bits.shape
    flat_bits = data.bits.reshape(b_bases * s, n).repeat(reps, 1)
    flat_basis = torch.from_numpy(np.asarray(data.basis_idx, np.int64)).to(
        dev).repeat_interleave(s).repeat(reps)
    out = diff.denoise_dataset(g_sample, model, flat_bits, flat_basis, t_star,
                               schedule, exact=cfg.diffusion.exact)
    samples = (out.reshape(reps, b_bases, s, n).transpose(0, 1)
               .reshape(b_bases, reps * s, n))
    synchronize(dev)
    timings["denoise"] = time.perf_counter() - t0
    return samples


def _generate(cfg: ExperimentConfig, model, schedule,
              g_sample: torch.Generator, dev: torch.device, timings: dict,
              log_fn: Callable) -> torch.Tensor:
    """Generate mode: ``shots_infer`` samples in every canonical basis
    through the grid tables and the walk; ``timings['tables'|'walk']``."""
    n = cfg.data.num_qubits
    if diff._resolve_exact(schedule, cfg.diffusion.exact):
        log_fn(
            f"[{cfg.name}] NOTE: exact factorised posterior in use "
            "(reference parity); pass sampler='renoise' for best "
            "reconstruction quality"
        )
    log_fn(f"[{cfg.name}] sampling {cfg.data.shots_infer}/basis")
    num_bases = 3**n
    shots = cfg.data.shots_infer
    timings["tables"] = timings["walk"] = 0.0
    if cfg.diffusion.gen_tables_once:
        # The tables once, then walks of at most _GEN_CHAIN_CAP chains.
        samples = diff.sample_all_bases_chunked(
            g_sample, model, n, shots, schedule, exact=cfg.diffusion.exact,
            max_chains=_GEN_CHAIN_CAP, device=dev, timings=timings)
    else:
        cap = max(1, _GEN_CHAIN_CAP // num_bases)
        n_calls = -(-shots // cap)
        per_call = -(-shots // n_calls)  # equal chunks
        chunks = []
        for _ in range(n_calls):
            part: dict[str, float] = {}
            chunks.append(diff.sample_all_bases(
                g_sample, model, n, per_call, schedule,
                exact=cfg.diffusion.exact, device=dev, timings=part,
            ))
            for k, v in part.items():
                timings[k] += v
        samples = (torch.cat(chunks, dim=1)[:, :shots] if n_calls > 1
                   else chunks[0])
    return samples


def _distill_only(losses, ft_losses, ft_info) -> dict:
    """The result of ``stop_after='distill'``: the training record only."""
    return {
        "losses": losses.detach().cpu().numpy(),
        "ft_losses": None if ft_info is None else ft_losses.cpu().numpy(),
        "ft_info": ft_info,
    }


def shadow_metrics(gen_counts: np.ndarray, meas_counts: np.ndarray,
                   exact_p: np.ndarray, shots_gen: int, n: int) -> dict:
    """The shadow route's scores of generated counts ``[B, 2^N]`` against
    the exact Born probabilities ``exact_p`` ``[B, 2^N]``, in numpy, as
    :func:`_run_shadow_experiment` reports them: ``mean/max_tv_to_target``,
    ``tv_shot_noise_floor`` (mean TV of 4 multinomial draws of ``shots_gen``
    a basis from ``exact_p``, ``default_rng(0)``), ``meas_tv_to_target``
    (of the measured counts), ``mean/max_marginal_error`` and
    ``classical_fidelity``. A row of ``gen_counts`` may also be a
    distribution (a row that sums to 1)."""
    gen_p = gen_counts / np.maximum(gen_counts.sum(-1, keepdims=True), 1.0)
    meas_p = meas_counts / np.maximum(meas_counts.sum(-1, keepdims=True), 1.0)
    tv_gen = 0.5 * np.abs(gen_p - exact_p).sum(-1)
    tv_meas = 0.5 * np.abs(meas_p - exact_p).sum(-1)
    # Shot-noise floor: the TV an ideal sampler scores at this shot count.
    rng = np.random.default_rng(0)
    exact64 = exact_p.astype(np.float64)
    exact64 /= exact64.sum(-1, keepdims=True)  # an exact simplex for pvals
    floor = np.mean([
        0.5 * np.abs(rng.multinomial(shots_gen, p) / shots_gen - p).sum()
        for p in exact64
        for _ in range(4)
    ])
    outcomes = np.arange(exact_p.shape[-1])
    bit_table = ((outcomes[:, None] >> np.arange(n)) & 1).astype(np.float32)
    marg_err = np.abs((gen_p - exact_p) @ bit_table)  # [B, N]
    cf = np.sqrt(gen_p * exact_p).sum(-1) ** 2  # Bhattacharyya per basis
    return {
        "mean_tv_to_target": float(tv_gen.mean()),
        "max_tv_to_target": float(tv_gen.max()),
        "tv_shot_noise_floor": float(floor),
        "meas_tv_to_target": float(tv_meas.mean()),
        "mean_marginal_error": float(marg_err.mean()),
        "max_marginal_error": float(marg_err.max()),
        "classical_fidelity": float(cf.mean()),
    }


def _run_shadow_experiment(
    cfg: ExperimentConfig, seed: int, data: GeneratedData, dev: torch.device,
    g_train: torch.Generator, g_sample: torch.Generator, timings: dict,
    log_fn: Callable, mesh=None, params_load: str = "", params_save: str = "",
    stop_after: str = "", opt_load: str = "", opt_save: str = "",
) -> dict:
    """The shadow route (large N, sampled bases): train on per-qubit basis
    labels and score the generated distributions against the EXACT Born
    probabilities of the clean target (``data.clean_probs``), not a
    reconstructed density matrix (its 4^N expansion is out of reach).

    Results, as the JAX package's: ``fidelity`` (None), per basis against
    the exact distribution ``mean/max_tv_to_target`` (TV of the generated
    counts), ``tv_shot_noise_floor`` (mean TV of 4 multinomial draws a basis
    from the exact distribution at the generated shot count, numpy
    ``default_rng(0)``: what an ideal generator scores),
    ``meas_tv_to_target`` (TV of the measured counts),
    ``mean/max_marginal_error`` (|E[x_q]| error over basis and qubit),
    ``classical_fidelity`` (mean Bhattacharyya (Σ√(pq))²), ``z_bias`` (None
    when the Z...Z basis was not sampled), ``losses``, ``target``, ``state``
    (the model), ``samples`` and, after distillation, ``chain_info`` and
    ``ft_losses``; plus ``timings`` (datagen, train, target and distill,
    then tables and walk, or sample for the direct sampler, and metrics)
    and ``train_steps``.

    A model configured as anything but the transformer is switched to it
    with a warning: per-qubit ``[B, N]`` labels are the transformer's
    conditioning form, and ``ConditionalD3PM`` would read a 2-D basis as a
    packed (basis, circuit). ``params_load`` / ``params_save``,
    ``stop_after='distill'`` and ``opt_load`` / ``opt_save`` work as on the
    full route; distillation (``chain_finetune_steps > 0``) runs the exact
    chain over exactly the measured bases, with the shot-level held-out
    split of ``chain_val_fraction``.
    """
    n = cfg.data.num_qubits
    b_bases, s, _ = data.bits.shape
    mcfg = cfg.model
    if mcfg.arch != "transformer":
        log_fn(f"[{cfg.name}] WARNING: arch={mcfg.arch!r} cannot condition on "
               "per-qubit basis labels at shadow scale; switching to "
               "arch='transformer'")
        mcfg = dataclasses.replace(mcfg, arch="transformer")
    schedule = make_schedule(cfg.diffusion.schedule,
                             cfg.diffusion.num_timesteps, dev)
    model = build_model(mcfg, n, cfg.diffusion.num_timesteps).to(dev)
    labels = torch.from_numpy(np.asarray(data.basis_labels, np.int64)).to(dev)

    t0 = time.perf_counter()
    train_steps = 0
    if params_load:
        restore_params(params_load, model).eval()
        losses = torch.zeros(0)
        log_fn(f"[{cfg.name}] warm start: params from {params_load} "
               "(CE training skipped)")
    else:
        x = data.bits.reshape(b_bases * s, n)
        log_fn(f"[{cfg.name}] shadow-scale training on {x.shape[0]} shots "
               f"({b_bases} bases)")
        model, losses = training.fit(
            g_train, model, x, labels.repeat_interleave(s, dim=0), cfg.train,
            schedule, mesh=mesh, log_fn=log_fn, device=dev)
        train_steps = (max(x.shape[0] // min(cfg.train.batch_size, x.shape[0]),
                           1) * len(losses))
    synchronize(dev)
    timings["train"] = time.perf_counter() - t0

    ft_info = ft_losses = None
    if cfg.train.chain_finetune_steps > 0:
        ft_losses, ft_info = _distill(
            cfg, seed, data, model, schedule, dev, "", opt_load, opt_save,
            timings, {}, log_fn, shadow=True)
    if params_save:
        save_params(params_save, model)
        log_fn(f"[{cfg.name}] saved params to {params_save}")
    if stop_after == "distill":
        return _distill_only(losses, ft_losses, ft_info)

    shots_gen = max(cfg.data.shots_infer, 1)
    log_fn(f"[{cfg.name}] sampling {shots_gen}/basis over {b_bases} bases")
    part: dict[str, float] = {}
    t0 = time.perf_counter()
    samples = diff.sample_for_bases(g_sample, model, labels, shots_gen,
                                    schedule, exact=cfg.diffusion.exact,
                                    device=dev, timings=part)
    synchronize(dev)
    timings.update(part or {"sample": time.perf_counter() - t0})

    t0 = time.perf_counter()
    results = {
        "fidelity": None,  # no density matrix at this scale
        **shadow_metrics(bits_to_counts(samples).cpu().numpy(),
                         bits_to_counts(data.bits).cpu().numpy(),
                         np.asarray(data.clean_probs), shots_gen, n),
    }
    zz_rows = np.nonzero((np.asarray(data.basis_labels) == 2).all(axis=1))[0]
    # None: the Z...Z basis was not sampled (a missing diagnostic is
    # reported as missing, not as its ideal value).
    zb = float(M.z_bias(samples[int(zz_rows[0])])) if len(zz_rows) else None
    results.update({
        "z_bias": zb,
        "losses": losses.detach().cpu().numpy(),
        "target": np.asarray(data.target),
        "state": model,
        "samples": samples,
        "train_steps": train_steps,
        "timings": timings,
    })
    if ft_info is not None:
        results["chain_info"] = ft_info
        results["ft_losses"] = ft_losses.cpu().numpy()
    timings["metrics"] = time.perf_counter() - t0
    log_fn(
        f"[{cfg.name}] shadow-scale vs exact Born probs: "
        f"TV {results['mean_tv_to_target']:.4f} "
        f"(shot-noise floor {results['tv_shot_noise_floor']:.4f}, "
        f"measured-data TV {results['meas_tv_to_target']:.4f}), marginal err "
        f"{results['mean_marginal_error']:.4f}, classical fidelity "
        f"{results['classical_fidelity']:.4f} over {b_bases} bases"
    )
    return results


def create_sanity_records(num_qubits: int) -> list[CircuitRecord]:
    """Synthetic Bell-correlation dataset for the memorisation check: 500 x
    '00..0' and 500 x '11..1' counts in the Z basis only."""
    d = 2**num_qubits
    counts = np.zeros((1, d), np.int32)
    counts[0, 0] = 500
    counts[0, d - 1] = 500
    target = np.zeros(d, np.complex64)
    target[0] = target[-1] = 1 / np.sqrt(2)
    return [
        CircuitRecord(
            id=0,
            hash="sanity",
            depth=0,
            clean_state=target,
            basis_labels=np.full((1, num_qubits), 2, np.int8),  # Z...Z
            counts=counts,
        )
    ]


def train_on_dataset(
    cfg: ExperimentConfig,
    records,
    save_dir: str = "",
    run_name: str = "model",
    train_ratio: float = 1.0,
    num_eval_circuits: int = 50,
    seed: int = 0,
    log_fn: Callable = print,
    device: str | torch.device | None = None,
) -> tuple[torch.nn.Module, list[CircuitRecord]]:
    """Phase-4 style training on a prebuilt circuit dataset.

    Shuffles the circuits with ``np.random.default_rng(seed).shuffle`` (as
    the JAX package does, so the same circuits land in the same places),
    keeps ``train_ratio`` of them, and evaluates on the first
    ``num_eval_circuits`` *training* circuits (the reference's deliberate
    memorisation protocol). With ``cfg.model.condition_on_circuit`` the
    model gets one circuit embedding per training circuit and trains on
    packed (basis, circuit) conditioning; the eval subset is a prefix of
    the training circuits, so its circuit ids are the model's.

    With ``save_dir`` it writes ``{run_name}_eval.npz`` (the eval subset, in
    order) and ``{run_name}_params.pt`` (the state dict). Runs on
    ``device`` (default CUDA; raises if CUDA is absent and ``device`` was
    not given). Returns ``(model, eval_records)``.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    records = list(records)
    rng.shuffle(records)
    num_train = max(int(len(records) * train_ratio), 1)
    training_recs = records[:num_train]
    eval_recs = training_recs[: max(1, num_eval_circuits)]
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        save_shard(os.path.join(save_dir, f"{run_name}_eval.npz"), eval_recs)

    arrays = dataset_to_training_arrays(training_recs, mode="unroll")
    eval_arrays = dataset_to_training_arrays(eval_recs, mode="unroll")
    log_fn(f"training on {arrays['bits'].shape[0]} shots "
           f"({len(training_recs)} circuits)")
    schedule = make_schedule(cfg.diffusion.schedule,
                             cfg.diffusion.num_timesteps, dev)
    num_circuits = len(training_recs) if cfg.model.condition_on_circuit else 0
    model = build_model(cfg.model, cfg.data.num_qubits,
                        cfg.diffusion.num_timesteps, num_circuits).to(dev)

    def cond(a):  # packed (basis, circuit) when circuit-conditioned
        if num_circuits == 0:
            return a["basis_idx"]
        return torch.stack([a["basis_idx"], a["circuit_idx"]], dim=-1)

    _, g_train, _ = _generators(seed, dev)
    model, _ = training.fit(
        g_train, model, arrays["bits"], cond(arrays), cfg.train, schedule,
        eval_bits=eval_arrays["bits"], eval_basis=cond(eval_arrays),
        log_fn=log_fn, device=dev,
    )
    if save_dir:
        path = os.path.join(save_dir, f"{run_name}_params.pt")
        save_params(path, model)
        log_fn(f"saved params to {path}")
    return model, eval_recs
