"""The campaigns' shared recipes, as plain functions of
``ddqst_tpu_torch.config``: the port's copies of ``quality_cfg``
(``scripts/run_parity_suite.py:60-81``), ``coverage_steps`` and
``auto_recipe`` (``scripts/run_scaling_ghz.py:29-66``), and ``diag_cfg``
(the GHZ-5 diagnostics' ``make_cfg``)."""

from __future__ import annotations

from ddqst_tpu_torch.config import ExperimentConfig, get_preset


def quality_cfg(name: str, *, num_qubits: int, state: str, shots_train: int,
                shots_infer: int, noise: str = "readout", depth: int = 5,
                epochs: int = 300) -> ExperimentConfig:
    """The quality stack: the ``rqc`` preset's FiLM ``ConditionalD3PM``
    (128 / 512 / 4 blocks), T = 100, cosine schedule, renoise sampler,
    readout-mitigated training data and reconstruction, MLE."""
    base = get_preset("rqc")
    return base.replace(
        name=name,
        diffusion=type(base.diffusion)(num_timesteps=100, schedule="cosine",
                                       sampler="renoise"),
        train=type(base.train)(batch_size=1024, learning_rate=1e-3,
                               optimizer="adam", num_epochs=epochs,
                               lr_schedule="cosine", log_every=0,
                               eval_every=0, chain_finetune_steps=400,
                               chain_lr=3e-4),
        data=type(base.data)(num_qubits=num_qubits, state_type=state,
                             noise_type=noise, shots_train=shots_train,
                             shots_infer=shots_infer, rqc_depth=depth,
                             mitigate_readout=True, mitigate_train_data=True,
                             reconstruction="mle"),
    )


def coverage_steps(num_qubits: int, basis_batch: int, accum: int = 1,
                   epochs_equiv: float = 94.0) -> int:
    """A distillation budget from grid coverage: the steps that pass
    ``epochs_equiv`` times over the 3^N-basis grid at ``basis_batch`` bases
    a minibatch and ``accum`` minibatches a step (94, the N=7-validated
    operating point)."""
    return int(round(epochs_equiv * 3**num_qubits / (basis_batch * accum)))


def auto_recipe(cfg: ExperimentConfig, *, basis_batch: int = 0,
                steps_per_call: int = 25, epochs: int | None = None,
                target: str = "counts", val_patience: int = 4,
                val_fraction: float = 0.15, steps: int = 800,
                accum: int = 1) -> ExperimentConfig:
    """The automated distillation recipe, one config across N: a generous
    step budget at a hot learning rate, the held-out step selection
    choosing the stopping point; ``basis_batch`` bounds the grid rows a
    step at N >= 6."""
    tr = cfg.train
    return cfg.replace(train=type(tr)(
        batch_size=1024, learning_rate=1e-3, optimizer="adam",
        num_epochs=tr.num_epochs if epochs is None else epochs,
        lr_schedule="cosine", log_every=0, eval_every=0,
        chain_finetune_steps=steps, chain_lr=1e-3,
        chain_val_fraction=val_fraction, chain_val_patience=val_patience,
        chain_basis_batch=basis_batch, chain_steps_per_call=steps_per_call,
        chain_target=target, chain_accum=accum))


def diag_cfg(name: str, num_qubits: int = 5,
             epochs: int = 10) -> ExperimentConfig:
    """The GHZ-5 diagnostics' regime (``make_cfg`` of
    ``scripts/diag_segment_descent.py``, ``diag_floor_escape.py`` and
    ``diag_hard_mining.py``, which differ only in ``name``): the ``rqc``
    preset with a FiLM 32 / 64 / 2 token model, T = 100 cosine with the
    renoise sampler, batch 1,024 for ``epochs`` epochs, GHZ under readout
    noise, 500 mitigated training shots a basis."""
    base = get_preset("rqc")
    return base.replace(
        name=name,
        model=type(base.model)(input_encoding="token", embed_dim=32,
                               hidden_dim=64, num_blocks=2),
        diffusion=type(base.diffusion)(num_timesteps=100, schedule="cosine",
                                       sampler="renoise"),
        train=type(base.train)(batch_size=1024, learning_rate=1e-3,
                               optimizer="adam", num_epochs=epochs,
                               lr_schedule="cosine", log_every=0,
                               eval_every=0),
        data=type(base.data)(num_qubits=num_qubits, state_type="ghz",
                             noise_type="readout", shots_train=500,
                             shots_infer=1000, mitigate_train_data=True),
    )
