"""Rank processes for tests/test_torch_parallel.py and
tests/test_torch_parallel_route.py. No tests here.

A spawned rank imports the module that defines its function, and never
``conftest.py``, so this module imports no JAX: every JAX reference is
computed in the pytest process, and the two sides exchange files under a
temporary directory (``torch.save`` dicts, one per rank).
"""

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ddqst_tpu_torch import train as training
from ddqst_tpu_torch.config import ModelConfig, TrainConfig, get_preset
from ddqst_tpu_torch.models import build_model, params_from_flax
from ddqst_tpu_torch.ops import diffusion as diff
from ddqst_tpu_torch.ops import schedules
from ddqst_tpu_torch.parallel import mesh as pm
from ddqst_tpu_torch.parallel import tensor as tp

SHOTS = 600  # generated shots a basis in the run_experiment checks


def spawn_world(fn, world: int, workdir: str, *args) -> list[dict]:
    """Run ``fn(rank, mesh_args..., workdir, *args)`` in ``world`` spawned
    ranks of one gloo world; returns each rank's saved results, by rank. A
    failed rank raises here."""
    mp.start_processes(_entry, args=(fn, world, pm.free_port(), workdir, args),
                       nprocs=world, start_method="spawn")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _entry(rank, fn, world, port, workdir, args):
    torch.set_num_threads(1)
    pm.init_distributed(f"localhost:{port}", world, rank, backend="gloo")
    try:
        out = fn(rank, workdir, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def layout(mesh: pm.Mesh) -> dict:
    return dict(shape=mesh.shape, rank=mesh.rank, coords=mesh.coords,
                data_ranks=mesh.data_ranks, model_ranks=mesh.model_ranks,
                device=str(mesh.device), backend=mesh.backend)


def dp_setup():
    """``tests/test_parallel.py:27-52``: n=2, token FiLM MLP 8 / 32 / 1
    block, cosine(8), batch 64, 3 epochs, 256 rows."""
    rng = np.random.default_rng(0)
    bits = torch.from_numpy(rng.integers(0, 2, (256, 2)).astype(np.int8))
    basis = torch.from_numpy(rng.integers(0, 9, (256,)))
    model = build_model(ModelConfig(embed_dim=8, hidden_dim=32, num_blocks=1,
                                    input_encoding="token"), 2, 8)
    cfg = TrainConfig(batch_size=64, num_epochs=3, optimizer="adam",
                      log_every=0, eval_every=0)
    return model, bits, basis, cfg, schedules.cosine_schedule(8)


def tp_setup():
    """``tests/test_parallel.py:84-125``: n=10, E=256, hidden 1024, 8 heads,
    2 blocks, batch 64, 2 epochs, 256 rows."""
    rng = np.random.default_rng(1)
    bits = torch.from_numpy(rng.integers(0, 2, (256, 10)).astype(np.int8))
    basis = torch.from_numpy(rng.integers(0, 3, (256, 10)))
    model = build_model(ModelConfig(arch="transformer", input_encoding="token",
                                    embed_dim=256, hidden_dim=1024,
                                    num_blocks=2, num_heads=8), 10, 8)
    cfg = TrainConfig(batch_size=64, num_epochs=2, optimizer="adam",
                      log_every=0, eval_every=0)
    return model, bits, basis, cfg, schedules.cosine_schedule(8)


def fit(setup, mesh=None, **change):
    """``fit`` of a setup on the CPU, its config changed by ``change``:
    (losses, whole state dict, the optimiser ``fit`` built)."""
    model, bits, basis, cfg, sched = setup()
    cfg = dataclasses.replace(cfg, **change)
    made = []
    make = training.make_optimizer

    def recording(cfg, params):
        made.append(make(cfg, params))
        return made[-1]

    training.make_optimizer = recording
    try:
        model, losses = training.fit(torch.Generator().manual_seed(0), model,
                                     bits, basis, cfg, sched, mesh=mesh,
                                     device="cpu", log_fn=lambda m: None)
    finally:
        training.make_optimizer = make
    return losses, {k: v.clone() for k, v in model.state_dict().items()}, made[0]


def resumed(setup, mesh, workdir, name):
    """A run checkpointed after epoch 1 of the setup's epochs, then resumed
    to its end: (the resumed epochs' losses, the whole state dict)."""
    ckpt = os.path.join(workdir, f"ckpt_{name}")
    epochs = setup()[3].num_epochs
    fit(setup, mesh, num_epochs=1, checkpoint_dir=ckpt)
    losses, sd, _ = fit(setup, mesh, num_epochs=epochs, checkpoint_dir=ckpt,
                        resume=True)
    return losses, sd


def small_rqc(epochs=2):
    """The rqc preset cut to a CPU test (tests/test_torch_pipeline.py's
    ``_small``), at fewer generated shots."""
    c = get_preset("rqc")
    return c.replace(
        model=dataclasses.replace(c.model, embed_dim=16, hidden_dim=32,
                                  num_blocks=2),
        diffusion=dataclasses.replace(c.diffusion, num_timesteps=20),
        train=dataclasses.replace(c.train, num_epochs=epochs),
        data=dataclasses.replace(c.data, shots_infer=SHOTS),
    )


def small_shadow():
    """The shadow route at a CPU test's size: N=7, 8 sampled bases, a
    transformer 16 / 32 / 1 block / 2 heads, T=10, 2 epochs."""
    c = get_preset("shadow_transformer")
    return c.replace(
        model=dataclasses.replace(c.model, embed_dim=16, hidden_dim=32,
                                  num_blocks=1, num_heads=2),
        diffusion=dataclasses.replace(c.diffusion, num_timesteps=10),
        train=dataclasses.replace(c.train, num_epochs=2),
        data=dataclasses.replace(c.data, num_qubits=7, max_bases=8,
                                 shots_train=256, shots_infer=300),
    )


def summary(res: dict) -> dict:
    """The parts of a run_experiment result the tests compare."""
    keep = ("fidelity", "raw_fidelity", "trace_distance", "purity", "rho",
            "losses", "mean_tv_to_target", "classical_fidelity",
            "train_steps")
    out = {k: res[k] for k in keep if k in res}
    out["samples"] = res["samples"].cpu()
    out["state"] = {k: v.cpu() for k, v in res["state"].state_dict().items()}
    return out


def two_rank_checks(rank, workdir, flax_file):
    """tests/test_torch_parallel.py's world: 2 ranks."""
    from ddqst_tpu_torch import pipeline

    out = {}
    dp = pm.make_mesh(data=2, device="cpu")
    tpm = pm.make_mesh(data=1, model=2, device="cpu")
    out["layout"] = [layout(dp), layout(tpm), layout(pm.make_mesh(device="cpu"))]

    losses, sd, _ = fit(dp_setup, dp)
    out["dp_losses"], out["dp_state"] = losses, sd
    out["dp_resumed"] = resumed(dp_setup, dp, workdir, "dp")

    # The tensor-parallel forward of flax-initialised weights, and shard /
    # gather bits.
    f = torch.load(flax_file, weights_only=False)
    model = build_model(ModelConfig(arch="transformer", embed_dim=16,
                                    hidden_dim=64, num_blocks=2, num_heads=2),
                        4, 8)
    model.load_state_dict(params_from_flax(f["params"]))
    whole = {k: v.clone() for k, v in model.state_dict().items()}
    tp.shard_params(tpm, model)
    local = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    with torch.no_grad():
        out["tp_logits"] = model(*(torch.from_numpy(f[k])
                                   for k in ("x", "t", "b")))
    tp.gather_params(tpm, model)
    out["tp_local_shapes"] = local
    out["tp_whole_shapes"] = {k: tuple(v.shape) for k, v in whole.items()}
    out["gather_same_bits"] = all(
        torch.equal(whole[k], v) for k, v in model.state_dict().items())
    with torch.no_grad():
        out["gathered_logits"] = model(*(torch.from_numpy(f[k])
                                         for k in ("x", "t", "b")))

    # The samplers on this data rank's rows, gathered.
    sched = schedules.cosine_schedule(5)

    def uniform(x, t, b):
        return torch.zeros(x.shape + (2,))

    gen = torch.Generator().manual_seed(1 + dp.coords[0])
    rows = pm.shard_data(dp, torch.zeros(64, dtype=torch.int64))
    out["p_sample"] = pm.gather_data(dp, diff.p_sample(gen, uniform, rows, 3,
                                                       sched))
    rows = pm.shard_data(dp, torch.zeros(160, dtype=torch.int64))
    out["p_sample_grid"] = pm.gather_data(
        dp, diff.p_sample_grid(gen, uniform, rows, 2, sched))
    out["replicated"] = pm.replicate(dp, torch.full((3,), float(rank)))

    errors = {}

    def raises(what, fn):
        try:
            fn()
        except ValueError as e:
            errors[what] = str(e)

    model, bits, basis, cfg, sched8 = dp_setup()
    raises("uneven batch", lambda: training.fit(
        torch.Generator().manual_seed(0), model, bits, basis,
        dataclasses.replace(cfg, batch_size=63), sched8, mesh=dp,
        device="cpu"))
    three_heads = build_model(ModelConfig(arch="transformer", embed_dim=24,
                                          hidden_dim=64, num_blocks=1,
                                          num_heads=3), 4, 8)
    raises("heads", lambda: tp.shard_params(tpm, three_heads))
    raises("mesh size", lambda: pm.make_mesh(data=3, device="cpu"))
    raises("uneven rows", lambda: pm.shard_data(dp, torch.zeros(5)))
    out["errors"] = errors

    # run_experiment, data-parallel over both ranks.
    res = pipeline.run_experiment(small_rqc(), seed=0, mesh=dp, device="cpu",
                                  log_fn=lambda m: None)
    out["run"] = summary(res)
    return out


def four_rank_checks(rank, workdir):
    """tests/test_torch_parallel_route.py's world: 4 ranks, a 2 x 2 mesh."""
    from ddqst_tpu_torch import pipeline

    mesh = pm.make_mesh(data=2, model=2, device="cpu")
    out = {"layout": layout(mesh)}
    losses, sd, opt = fit(tp_setup, mesh)
    out["tp_losses"], out["tp_state"] = losses, sd
    out["tp_resumed"] = resumed(tp_setup, mesh, workdir, "tp")
    # The optimiser holds this rank's shards: its parameters are in the
    # whole model's order, with the moments of the shards.
    out["moment_shapes"] = {
        name: (tuple(opt.state[p]["exp_avg"].shape),
               tuple(opt.state[p]["exp_avg_sq"].shape))
        for name, p in zip(sd, opt.param_groups[0]["params"])}
    res = pipeline.run_experiment(small_shadow(), seed=0, mesh=mesh,
                                  device="cpu", log_fn=lambda m: None)
    out["shadow"] = summary(res)
    return out


def cuda_tp_forward(rank, workdir):
    """The shadow preset's transformer, seeded, on the card: the largest
    difference between its whole forward and its split one (data 1 x model
    2, both ranks on one card)."""
    from ddqst_tpu_torch.models.d3pm import init_params_

    mesh = pm.make_mesh(data=1, model=2)
    cfg = get_preset("shadow_transformer")
    n, t_steps = cfg.data.num_qubits, cfg.diffusion.num_timesteps
    gen = torch.Generator(device=mesh.device).manual_seed(3)
    model = build_model(cfg.model, n, t_steps).to(mesh.device)
    init_params_(model, gen)
    x = torch.randint(0, 2, (256, n), generator=gen, device=mesh.device)
    t = torch.randint(1, t_steps + 1, (256,), generator=gen, device=mesh.device)
    b = torch.randint(0, 3, (256, n), generator=gen, device=mesh.device)
    with torch.no_grad():
        whole = model(x, t, b)
        tp.shard_params(mesh, model)
        split = model(x, t, b)
    return dict(err=float((whole - split).abs().max()), device=str(mesh.device))
