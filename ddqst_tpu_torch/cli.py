"""Command-line interface: generate / train / evaluate / run / convert.

The port's counterpart of ``ddqst_tpu/cli.py``, with the same subcommands
and flags plus ``--device`` (default ``cuda``; without CUDA every
subcommand but ``convert`` raises unless ``--device cpu`` is given), and
``--checkpoint_every`` / ``--resume`` beside ``--checkpoint_dir``.

  python -m ddqst_tpu_torch.cli run --preset special_states --state_type bell
  python -m ddqst_tpu_torch.cli run --preset shadow_transformer  # N=10 shadow
  python -m ddqst_tpu_torch.cli run --preset notebook_simple     # PlainMLP
  python -m ddqst_tpu_torch.cli run --preset rqc --infer_mode denoise
  python -m ddqst_tpu_torch.cli run --preset rqc --dtype bfloat16 \
      --checkpoint_dir ckpt --checkpoint_every 5 --resume
  python -m ddqst_tpu_torch.cli generate --samples 1000 --qubits 3 --out_dir ds
  python -m ddqst_tpu_torch.cli train --data_path ds --save_dir exp --run_name m1
  python -m ddqst_tpu_torch.cli train --sanity_check        # memorisation smoke
  python -m ddqst_tpu_torch.cli evaluate --params exp/m1_params.pt \\
      --eval_data exp/m1_eval.npz --out_dir results
  python -m ddqst_tpu_torch.cli convert --src <ref>/Datapoints/rqc_N3_data --out ds
  torchrun --nproc_per_node 2 -m ddqst_tpu_torch.cli run --data_parallel 2

``run --data_parallel R`` trains data-parallel over R ranks, one process
each, as ``torchrun`` starts them; every rank runs the whole pipeline and
rank 0 logs. As in the JAX package, ``train`` and ``evaluate`` take the flag
and ignore it.

A circuit-conditioned model (``--condition_on_circuit``) is evaluated with
``--num_circuits`` equal to its training circuit count (by default the eval
record count, which equals it when every training circuit is in the eval
subset); a mismatch fails the strict params load.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def _add_config_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", default="rqc",
                   help="config preset (reference phase)")
    # Data
    p.add_argument("--num_qubits", type=int)
    p.add_argument("--state_type",
                   choices=["plus", "bell", "ghz", "w", "rqc"])
    p.add_argument("--noise_type",
                   choices=["torino", "ideal", "readout", "depolarizing",
                            "thermal"])
    p.add_argument("--rqc_depth", type=int)
    p.add_argument("--shots_train", type=int)
    p.add_argument("--shots_infer", type=int)
    p.add_argument("--max_bases", type=int,
                   help="shadow cap on measured bases (0 = all 3^N)")
    p.add_argument("--mitigate_readout", action="store_true", default=None)
    p.add_argument("--mitigate_train_data", action="store_true", default=None,
                   help="train on readout-mitigated counts (quality path)")
    p.add_argument("--reconstruction", choices=["linear", "mle"])
    # Diffusion
    p.add_argument("--timesteps", type=int, dest="num_timesteps")
    p.add_argument("--schedule", choices=["linear", "cosine"])
    p.add_argument("--sampler", choices=["auto", "exact", "renoise"])
    p.add_argument("--infer_mode", choices=["generate", "denoise"])
    p.add_argument("--gen_tables_once", action="store_true", default=None,
                   help="amortised generation: the grid tables once in "
                        "bounded chunks, then table walks per shot chunk")
    # Model
    p.add_argument("--arch", choices=["film_mlp", "plain_mlp", "transformer"])
    p.add_argument("--input_encoding", choices=["float", "token"])
    p.add_argument("--condition_on_circuit", action="store_true", default=None,
                   help="circuit-identity conditioning (must match how the "
                        "params were trained)")
    p.add_argument("--embed_dim", type=int)
    p.add_argument("--hidden_dim", type=int)
    p.add_argument("--num_blocks", type=int, dest="num_blocks")
    p.add_argument("--dtype", choices=["float32", "bfloat16"])
    # Train
    p.add_argument("--epochs", type=int, dest="num_epochs")
    p.add_argument("--batch_size", type=int)
    p.add_argument("--lr", type=float, dest="learning_rate")
    p.add_argument("--optimizer", choices=["adamw", "adam", "sgd"])
    p.add_argument("--lr_schedule", choices=["constant", "cosine"])
    p.add_argument("--ema_decay", type=float)
    p.add_argument("--chain_finetune_steps", type=int,
                   help="exact-chain distillation steps after CE training "
                        "(0 = off)")
    p.add_argument("--chain_lr", type=float)
    p.add_argument("--chain_val_fraction", type=float)
    p.add_argument("--chain_val_patience", type=int)
    p.add_argument("--chain_basis_batch", type=int)
    p.add_argument("--chain_steps_per_call", type=int)
    p.add_argument("--chain_target", choices=["counts", "mle"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint_dir")
    p.add_argument("--checkpoint_every", type=int,
                   help="epochs between checkpoints (0 = at the end only)")
    p.add_argument("--resume", action="store_true", default=None,
                   help="resume training from the newest checkpoint in "
                        "--checkpoint_dir")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="data-axis mesh size (0 = single device); run "
                        "reads it, under torchrun with as many processes")
    _add_device_flag(p)


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; raises "
                        "without CUDA unless 'cpu' is given)")


def _build_config(args):
    from ddqst_tpu_torch.config import get_preset

    cfg = get_preset(args.preset)

    def overlay(section):
        updates = {
            f.name: getattr(args, f.name)
            for f in dataclasses.fields(section)
            if getattr(args, f.name, None) is not None
        }
        return dataclasses.replace(section, **updates)

    return cfg.replace(
        model=overlay(cfg.model),
        diffusion=overlay(cfg.diffusion),
        train=overlay(cfg.train),
        data=overlay(cfg.data),
    )


def _mesh_for(args):
    """``--data_parallel R``: a data-axis mesh over the R ranks of the world
    ``torchrun`` started (one rank needs no launcher); None without it."""
    r = args.data_parallel
    if not r:
        return None
    import torch.distributed as dist

    from ddqst_tpu_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed()
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != r:
        raise ValueError(
            f"--data_parallel {r} runs one process a rank, and this world has "
            f"{world}; start it as: torchrun --nproc_per_node {r} -m "
            f"ddqst_tpu_torch.cli run --data_parallel {r} [flags]")
    return make_mesh(data=r, device=args.device)


def cmd_run(args) -> int:
    import numpy as np
    import torch.distributed as dist

    from ddqst_tpu_torch import pipeline

    cfg = _build_config(args)
    mesh = _mesh_for(args)
    try:
        res = pipeline.run_experiment(cfg, seed=args.seed, mesh=mesh,
                                      device=args.device)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    if args.plots and (mesh is None or mesh.rank == 0):
        # A plotting failure must not sink the run.
        try:
            from ddqst_tpu_torch import viz

            viz.plot_state_city(res["rho"], f"fidelity {res['fidelity']:.4f}",
                                f"{cfg.name}_city.png")
            viz.plot_error_heatmap(np.outer(res["target"],
                                            res["target"].conj()),
                                   res["rho"], f"{cfg.name}_error_heatmap.png")
            viz.plot_losses(res["losses"], f"{cfg.name}_loss.png")
            print(f"plots saved with prefix {cfg.name}_")
        except Exception as e:
            print(f"visualization error: {e}")
    return 0


def cmd_generate(args) -> int:
    from ddqst_tpu_torch.data.generate import build_dataset_chunked

    paths = build_dataset_chunked(
        seed=args.seed,
        num_samples=args.samples,
        num_qubits=args.qubits,
        out_dir=args.out_dir,
        chunk_size=args.chunk_size,
        min_depth=args.min_depth,
        max_depth=args.max_depth,
        shots=args.shots,
        noise_type=args.noise,
        max_bases=args.max_bases,
        device=args.device,
    )
    print(f"wrote {len(paths)} shards to {args.out_dir}")
    return 0


def cmd_train(args) -> int:
    from ddqst_tpu_torch import pipeline
    from ddqst_tpu_torch.data.records import load_dataset

    cfg = _build_config(args)
    if args.sanity_check:
        print("GENERATING SYNTHETIC BELL STATE FOR SANITY CHECK")
        records = pipeline.create_sanity_records(cfg.data.num_qubits)
    else:
        records = load_dataset(args.data_path)
    pipeline.train_on_dataset(
        cfg, records,
        save_dir=args.save_dir,
        run_name=args.run_name,
        train_ratio=args.train_ratio,
        num_eval_circuits=args.num_eval_circuits,
        seed=args.seed,
        device=args.device,
    )
    return 0


def cmd_evaluate(args) -> int:
    import torch

    from ddqst_tpu_torch import evaluate as ev
    from ddqst_tpu_torch.data.records import load_dataset
    from ddqst_tpu_torch.device import resolve_device
    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.ops.schedules import make_schedule
    from ddqst_tpu_torch.qsim.noise import get_noise_config
    from ddqst_tpu_torch.utils.checkpoint import restore_params

    dev = resolve_device(args.device)
    cfg = _build_config(args)
    records = load_dataset(args.eval_data)
    n = records[0].num_qubits
    schedule = make_schedule(cfg.diffusion.schedule,
                             cfg.diffusion.num_timesteps, dev)
    # Circuit-conditioned params carry a circuit_emb table sized to the
    # training circuit count; the eval subset saved by train_on_dataset is
    # its prefix, so build the model with that vocabulary to restore.
    circuit_conditioned = bool(cfg.model.condition_on_circuit)
    num_circuits = args.num_circuits or (
        len(records) if circuit_conditioned else 0
    )
    model = build_model(cfg.model, n, cfg.diffusion.num_timesteps,
                        num_circuits).to(dev)
    restore_params(args.params, model).eval()
    readout_p = 0.0
    if cfg.data.mitigate_readout:
        readout_p = get_noise_config(cfg.data.noise_type).readout_p
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    ev.evaluate_dataset(
        generator, records, model, n, schedule,
        shots_infer=cfg.data.shots_infer,
        exact=cfg.diffusion.exact,
        reconstruction=cfg.data.reconstruction,
        readout_p=readout_p,
        circuit_conditioned=circuit_conditioned,
        out_dir=args.out_dir,
        device=dev,
    )
    return 0


def cmd_convert(args) -> int:
    from ddqst_tpu_torch.data.records import convert_reference_pt

    paths = convert_reference_pt(args.src, args.out)
    print(f"converted {len(paths)} shards into {args.out}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="ddqst_tpu_torch", description="DD-QST on PyTorch / CUDA"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("run", help="end-to-end generate/train/sample/reconstruct")
    _add_config_flags(p)
    p.add_argument("--plots", action="store_true")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("generate", help="build an RQC dataset (chunked shards)")
    p.add_argument("--samples", type=int, default=10000)
    p.add_argument("--qubits", type=int, default=3)
    p.add_argument("--min_depth", type=int, default=2)
    p.add_argument("--max_depth", type=int, default=10)
    p.add_argument("--shots", type=int, default=1024)
    p.add_argument("--chunk_size", type=int, default=500)
    p.add_argument("--noise", default="torino")
    p.add_argument("--max_bases", type=int, default=50)
    p.add_argument("--out_dir", default="dataset_parts")
    p.add_argument("--seed", type=int, default=0)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser("train", help="train on a prebuilt dataset")
    _add_config_flags(p)
    p.add_argument("--data_path", default="dataset_parts")
    p.add_argument("--save_dir", default="experiments/check")
    p.add_argument("--run_name", default="model")
    p.add_argument("--train_ratio", type=float, default=1.0)
    p.add_argument("--num_eval_circuits", type=int, default=50)
    p.add_argument("--sanity_check", action="store_true",
                   help="train on synthetic Bell correlations instead of data")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("evaluate", help="raw-vs-D3PM fidelity lift harness")
    _add_config_flags(p)
    p.add_argument("--params", required=True,
                   help="a {run_name}_params.pt written by train")
    p.add_argument("--eval_data", required=True)
    p.add_argument("--out_dir", default="results")
    p.add_argument("--num_circuits", type=int, default=0,
                   help="circuit-emb vocabulary size the params were trained "
                        "with (default: the eval record count)")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("convert", help="convert reference .pt parts to npz")
    p.add_argument("--src", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_convert)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
