"""One dataclass config tree with per-phase presets.

The port's own copy of ``ddqst_tpu/config.py`` (the port imports nothing
of the JAX package); the tests hold every preset field-for-field equal to
the JAX one.

Replaces the reference's four drifting ``config.py`` DEFAULTS dicts
(``multi_qubit_special_states/config.py:3-24``,
``multi_qubit_any_state/config.py:3-24``,
``RQC_dataset_building_phase/config.py:3-22``) plus per-file argparse
defaults. Each reference phase is a named preset; the CLI overlays flags on
top of a preset.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str = "film_mlp"  # 'film_mlp' | 'plain_mlp' | 'transformer'
    input_encoding: str = "float"  # 'float' (phases 1-3) | 'token' (phase 4)
    embed_dim: int = 64
    hidden_dim: int = 512
    num_blocks: int = 4
    num_heads: int = 4  # transformer only
    # Beyond-reference: condition on circuit identity when training on a
    # multi-circuit dataset (enables per-circuit reconstruction; the
    # reference model blends all circuits - see models/d3pm.py).
    condition_on_circuit: bool = False
    dtype: str = "float32"  # compute dtype; 'bfloat16' for the TPU fast path


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    num_timesteps: int = 100
    schedule: str = "linear"  # 'linear' (phases 1-3) | 'cosine' (phase 4) | 'notebook' (phase-1 nb)
    # Reverse-step rule: 'auto' follows the schedule's reference-parity
    # default (linear->renoise, cosine->exact posterior); 'renoise' is the
    # quality path (see ops.diffusion.p_sample docstring).
    sampler: str = "auto"  # 'auto' | 'exact' | 'renoise'
    # Inference mode: 'generate' starts the reverse chain from uniform noise
    # (reference behaviour); 'denoise' starts from the *measured* shots at a
    # timestep matched to the readout flip rate — explicit readout-channel
    # inversion (see ops.diffusion.p_denoise).
    infer_mode: str = "generate"  # 'generate' | 'denoise'
    # Amortised generation: precompute the [T, 6^N] grid tables ONCE (in
    # bounded dispatches) and make every shot-chunk a pure table walk
    # (ops.diffusion.sample_all_bases_chunked). Opt-in: same distribution
    # as the default path but a different program/RNG stream, and only a
    # win when generation is chunked (N>=7, where the per-chunk table
    # precompute dominates; REQUIRED at N=8 where the fused precompute is
    # a single ~10-minute device program — over the relay crash horizon).
    gen_tables_once: bool = False

    def __post_init__(self):
        if self.schedule != "cosine" and self.sampler == "exact":
            raise ValueError(
                f"sampler='exact' is inconsistent with schedule="
                f"{self.schedule!r} (that family's cum_flip is the "
                "reference's one-shot quirk, not a cumulative flip "
                "probability); use sampler='renoise' or schedule='cosine'"
            )

    @property
    def exact(self) -> bool | None:
        return {"auto": None, "exact": True, "renoise": False}[self.sampler]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 256
    learning_rate: float = 1e-4
    optimizer: str = "adamw"  # 'adamw' (phases 2-3) | 'adam' (phase 4)
    lr_schedule: str = "constant"  # 'constant' (reference) | 'cosine'
    t_max: int = 0  # restrict training timesteps to [1, t_max]; 0 = full T
    # Per-epoch exponential moving average of params (0 = off), zero-init
    # + debiased (Adam-style) so early epochs never dominate long runs.
    # The final state carries the EMA params - cuts late-training
    # estimation noise. NOTE the decay is per EPOCH: pick d so the horizon
    # 1/(1-d) is a fraction of num_epochs (e.g. 0.99 for 500 epochs).
    ema_decay: float = 0.0
    # Exact-chain distillation (beyond-reference; see train.finetune_chain):
    # after CE training, fine-tune the denoiser on the reverse chain's EXACT
    # output distribution vs the training counts for this many full-batch
    # Adam steps (0 = off). Only applies at small N with the full canonical
    # basis set and infer_mode='generate'.
    chain_finetune_steps: int = 0
    chain_lr: float = 1e-4
    # Distillation basis minibatch (0 = full 3^N set per step): bounds the
    # per-step grid at chain_basis_batch*2^N rows for N >= 6.
    chain_basis_batch: int = 0
    # Gradient accumulation over this many disjoint chain_basis_batch
    # minibatches per Adam step (train.finetune_chain accum): raises
    # per-step basis coverage accum-fold without raising the per-dispatch
    # grid size. The minibatch-noise-floor fix at N >= 8: the GHZ-8
    # campaign's chain-CE descent collapsed 13x at 1% coverage/step, and
    # the CPU A/B (scripts/diag_segment_descent.py) showed 4x coverage
    # out-descends 1x at equal step count (0.223 vs 0.168) while opt
    # chaining / lr decay do not.
    chain_accum: int = 1
    # Hard-basis mining (train.finetune_chain hard_frac): mix this
    # fraction of excess-KL-proportional weight into the minibatch draw.
    # Round-4 GHZ-8 measurement: after 4000 distillation steps the chain's
    # residual excess KL (0.011 nats mean) is concentrated in <~1% of the
    # 6561 bases (48 random bases read 0.0002) — the low-entropy Z-sector
    # that carries the GHZ coherence — and the uniform mean-CE draw
    # starves exactly those bases of gradient weight 100:1.
    chain_hard_frac: float = 0.0
    # Automated distillation temperature (the one-recipe criterion,
    # RESULTS.md "bias-variance knob"): hold out this fraction of training
    # shots per basis, step-select/early-stop distillation on the
    # held-out full-grid chain CE (see train.finetune_chain val_counts).
    # 0 = hand-tuned behaviour (run exactly chain_finetune_steps steps).
    chain_val_fraction: float = 0.0
    chain_val_patience: int = 4  # non-improving held-out evals before stop
    # Distillation target: 'counts' matches the chain to the per-basis
    # training-count frequencies; 'mle' first projects those counts through
    # the (PSD, trace-1) MLE manifold and matches the chain to the Born
    # distribution of the MLE estimate. Per-basis counts cannot express the
    # cross-basis positivity constraint — the measured gap between the
    # generative pipeline and MLE-on-raw (RESULTS.md) — so 'mle' bakes the
    # physical constraint into the generative model itself.
    chain_target: str = "counts"
    # Distillation steps per device dispatch (this environment's TPU
    # worker dies on single programs running >~2-4 min; lower for
    # expensive per-step models like the transformer).
    chain_steps_per_call: int = 25
    # Salt folded into the distillation PRNG key. The per-chunk key is
    # positional (fold_in(k0, step)), so a warm-started continuation run
    # (pipeline params_load) would replay run 1's basis-minibatch stream;
    # set a different salt per continuation to draw fresh minibatches.
    chain_key_salt: int = 0
    num_epochs: int = 300
    seed: int = 0
    eval_every: int = 5  # epochs between val-loss reports (phase 4: 5)
    log_every: int = 50  # epochs between train-loss prints (phases 2-3: 50)
    checkpoint_dir: str = ""
    checkpoint_every: int = 0  # epochs between mid-training checkpoints; 0 = final-only
    resume: bool = False  # restore latest checkpoint from checkpoint_dir
    # Not read, as in the JAX package: fit takes its mesh from ``mesh=``.
    data_axis: int = 1  # data-parallel mesh size (1 = single chip)
    model_axis: int = 1  # model-parallel mesh size (transformer only)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    num_qubits: int = 2
    state_type: str = "bell"  # 'plus' | 'bell' | 'ghz' | 'w' | 'rqc'
    noise_type: str = "readout"  # 'torino'|'ideal'|'readout'|'depolarizing'|'thermal'
    shots_train: int = 1000
    shots_infer: int = 10000
    rqc_depth: int = 5
    max_bases: int = 0  # 0 = all 3^N; >0 = shadow cap (builders use 50/100)
    # Closed-form readout error mitigation in the parity domain during
    # reconstruction (beyond-reference capability; see pauli.make_inverter).
    mitigate_readout: bool = False
    # Density-matrix estimator: 'linear' (reference parity) | 'mle'
    # (iterative RrhoR with noise-aware POVM; see ops.mle).
    reconstruction: str = "linear"
    # Train the generative model on readout-mitigated counts (confusion
    # matrix inverted, clipped, resampled) so it learns the *clean*
    # distribution; pairs with infer_mode='generate' + unmitigated
    # reconstruction of the generated samples.
    mitigate_train_data: bool = False


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "experiment"
    model: ModelConfig = ModelConfig()
    diffusion: DiffusionConfig = DiffusionConfig()
    train: TrainConfig = TrainConfig()
    data: DataConfig = DataConfig()

    def replace(self, **kw: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


def _cfg(**kw) -> ExperimentConfig:
    sub = {}
    for field, cls in (
        ("model", ModelConfig),
        ("diffusion", DiffusionConfig),
        ("train", TrainConfig),
        ("data", DataConfig),
    ):
        sub[field] = cls(**kw.pop(field, {}))
    return ExperimentConfig(**kw, **sub)


# One preset per reference phase (+ the large-N transformer stretch config).
PRESETS: dict[str, ExperimentConfig] = {
    # Phase 1 (single_qubit_phase notebook): 1-qubit |+>, basis-conditioned
    # MLP, 1024 shots/basis, ~200 epochs, batch 512.
    "single_qubit": _cfg(
        name="single_qubit",
        model=dict(embed_dim=64, hidden_dim=256, num_blocks=2),
        diffusion=dict(num_timesteps=100, schedule="linear"),
        train=dict(batch_size=512, learning_rate=1e-4, num_epochs=200),
        data=dict(num_qubits=1, state_type="plus", noise_type="readout",
                  shots_train=1024, shots_infer=10000),
    ),
    # Phase-1 notebook exact architectures (two-model comparison, cells
    # 6/12): plain concat-MLPs with the notebook's own p_stay=linspace(1,.5)
    # schedule and Adam 1e-3; synthetic samples = training shots.
    "notebook_simple": _cfg(
        name="notebook_simple",
        model=dict(arch="plain_mlp", embed_dim=32, hidden_dim=128,
                   num_blocks=2),
        diffusion=dict(num_timesteps=100, schedule="notebook"),
        train=dict(batch_size=512, learning_rate=1e-3, optimizer="adam",
                   num_epochs=200),
        data=dict(num_qubits=1, state_type="plus", noise_type="readout",
                  shots_train=1024, shots_infer=1024),
    ),
    "notebook_upgraded": _cfg(
        name="notebook_upgraded",
        model=dict(arch="plain_mlp", embed_dim=128, hidden_dim=256,
                   num_blocks=3),
        diffusion=dict(num_timesteps=100, schedule="notebook"),
        train=dict(batch_size=128, learning_rate=1e-3, optimizer="adam",
                   num_epochs=300),
        data=dict(num_qubits=1, state_type="plus", noise_type="readout",
                  shots_train=1024, shots_infer=1024),
    ),
    # Phase 2 (multi_qubit_special_states/config.py:3-24).
    "special_states": _cfg(
        name="special_states",
        model=dict(embed_dim=64, hidden_dim=512, num_blocks=4),
        diffusion=dict(num_timesteps=100, schedule="linear"),
        train=dict(batch_size=256, learning_rate=1e-4, optimizer="adamw",
                   num_epochs=300),
        data=dict(num_qubits=2, state_type="bell", noise_type="ideal",
                  shots_train=1000, shots_infer=10000),
    ),
    # Phase 3 (multi_qubit_any_state): same arch, 5 noise models, RQC states.
    "any_state": _cfg(
        name="any_state",
        model=dict(embed_dim=64, hidden_dim=512, num_blocks=4),
        diffusion=dict(num_timesteps=100, schedule="linear"),
        train=dict(batch_size=256, learning_rate=1e-4, optimizer="adamw",
                   num_epochs=300),
        data=dict(num_qubits=2, state_type="rqc", noise_type="readout",
                  shots_train=1000, shots_infer=10000, rqc_depth=5),
    ),
    # Phase 4 (RQC_dataset_building_phase/config.py:3-22): token-embedding
    # model, cosine schedule + exact posterior, Adam 1e-3, batch 1024.
    "rqc": _cfg(
        name="rqc",
        model=dict(input_encoding="token", embed_dim=128, hidden_dim=512,
                   num_blocks=4),
        diffusion=dict(num_timesteps=100, schedule="cosine"),
        train=dict(batch_size=1024, learning_rate=1e-3, optimizer="adam",
                   num_epochs=30),
        data=dict(num_qubits=3, state_type="rqc", noise_type="torino",
                  shots_train=1024, shots_infer=5000),
    ),
    # Stretch (BASELINE.json config 5): N=10+ transformer denoiser with
    # per-qubit basis tokens (3^N basis vocabulary is infeasible at N=10).
    "shadow_transformer": _cfg(
        name="shadow_transformer",
        model=dict(arch="transformer", input_encoding="token", embed_dim=128,
                   hidden_dim=512, num_blocks=4, num_heads=4),
        # sampler='renoise' (not the phase-4 parity 'exact'): the shadow
        # route is beyond-reference, and at N=10 the factorised exact
        # posterior's product-of-marginals error dominates (TV 0.446 vs
        # 0.213 renoise at the same budget — RESULTS.md "N=10 shadow").
        diffusion=dict(num_timesteps=100, schedule="cosine",
                       sampler="renoise"),
        train=dict(batch_size=1024, learning_rate=1e-3, optimizer="adam",
                   num_epochs=30),
        data=dict(num_qubits=10, state_type="rqc", noise_type="readout",
                  shots_train=1024, shots_infer=5000, rqc_depth=8,
                  max_bases=100),
    ),
}


def get_preset(name: str) -> ExperimentConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown preset {name!r}; options: {sorted(PRESETS)}"
        ) from None
