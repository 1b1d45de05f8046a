"""The first two distillation steps of the ``rqc4_auto`` recipe on the JAX
package's committed seed-0 data (``examples/reference_data/
rqc4_auto_seed0.npz``), the port against ``ddqst_tpu``, on the CPU.

Both start from one set of JAX-initialised parameters and run the recipe's
distillation (held-out split of 15% of the shots, the counts target, all 81
bases a step, lr 1e-3, the held-out selection) for two steps: the losses,
the chain CE before and after, the held-out history and the step it keeps,
the parameters and the Adam moments agree within ``TOL``. The width is cut
to a CPU test (embed 16, hidden 32, 1 block; the recipe's T = 100 and
shapes otherwise): the arithmetic of a step is the same at any width.
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from ddqst_tpu import pipeline as jpipe
from ddqst_tpu import train as jtrain
from ddqst_tpu.models import build_model as jbuild_model
from ddqst_tpu.ops import mle as jmle
from ddqst_tpu.ops.schedules import make_schedule as jmake_schedule
from ddqst_tpu_torch import pipeline as tpipe
from ddqst_tpu_torch.campaigns import scaling
from ddqst_tpu_torch.models import chain_opt_from_flax, params_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import run_scaling_ghz  # noqa: E402

torch.set_num_threads(1)

DATA = os.path.join(ROOT, "examples", "reference_data",
                    "rqc4_auto_seed0.npz")
TAG, N, STEPS = "rqc4_auto", 4, 2
TOL = 1e-5


def _cut(cfg):
    return cfg.replace(
        model=dataclasses.replace(cfg.model, embed_dim=16, hidden_dim=32,
                                  num_blocks=1),
        train=dataclasses.replace(cfg.train, chain_finetune_steps=STEPS))


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rqc4_distill")
    jc = _cut(next(c for t, c, _ in run_scaling_ghz.experiments()
                   if t == TAG))
    tc = _cut(scaling.experiment(TAG)[0])
    t_steps = jc.diffusion.num_timesteps
    data = jpipe.load_data_cache(DATA)
    _, k_train, _ = jax.random.split(jax.random.key(0), 3)
    state = jtrain.create_state(k_train, jbuild_model(jc.model, N, t_steps),
                                jc.train, N)
    ppath = str(tmp / "params.pt")
    torch.save(params_from_flax(
        jax.tree_util.tree_map(np.asarray, state.params)), ppath)

    # JAX: run_experiment's held-out split and distillation call
    # (ddqst_tpu/pipeline.py:677-737), on the file's data.
    tr = jc.train
    s = data.bits.shape[1]
    s_val = min(max(int(round(tr.chain_val_fraction * s)), 1), s - 1)
    jstate, jlosses, jinfo = jtrain.finetune_chain(
        state, jmle.bits_to_counts(data.bits[:, :s - s_val]),
        jmake_schedule(jc.diffusion.schedule, t_steps), N, steps=STEPS,
        learning_rate=tr.chain_lr, exact=jc.diffusion.exact,
        basis_batch=tr.chain_basis_batch,
        key=jax.random.fold_in(k_train, 0xD157 + tr.chain_key_salt),
        steps_per_call=tr.chain_steps_per_call,
        val_counts=jmle.bits_to_counts(data.bits[:, s - s_val:]),
        val_patience=tr.chain_val_patience, accum=tr.chain_accum,
        hard_frac=tr.chain_hard_frac)
    leaves = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    jopt = jinfo.pop("final_opt_state")

    # The port: run_experiment's distillation on the same file and params.
    out, opt = str(tmp / "distilled.pt"), str(tmp / "opt.pt")
    tres = tpipe.run_experiment(tc, seed=0, data_cache=DATA,
                                params_load=ppath, params_save=out,
                                opt_save=opt, stop_after="distill",
                                device="cpu", log_fn=lambda m: None)
    return dict(
        jax=dict(losses=np.asarray(jlosses), info=jinfo,
                 params=params_from_flax(leaves(jstate.params)),
                 opt=chain_opt_from_flax(leaves(jopt))),
        port=dict(losses=tres["ft_losses"], info=tres["ft_info"],
                  params=torch.load(out, weights_only=True),
                  opt=torch.load(opt, weights_only=True)))


def test_losses_chain_ce_and_held_out_choice_match_jax(steps):
    j, p = steps["jax"], steps["port"]
    assert len(p["losses"]) == len(j["losses"]) == STEPS
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=TOL)
    for k in ("train_ce_before", "train_ce_after", "best_val_ce"):
        assert p["info"][k] == pytest.approx(float(j["info"][k]), rel=TOL), k
    assert p["info"]["best_step"] == int(j["info"]["best_step"])
    assert [s for s, _ in p["info"]["val_history"]] == [
        int(s) for s, _ in j["info"]["val_history"]]
    np.testing.assert_allclose([c for _, c in p["info"]["val_history"]],
                               [float(c) for _, c in j["info"]["val_history"]],
                               rtol=TOL)


def test_parameters_and_adam_moments_match_jax(steps):
    j, p = steps["jax"], steps["port"]
    assert p["params"].keys() == j["params"].keys()
    for k, v in p["params"].items():
        np.testing.assert_allclose(v.numpy(), j["params"][k].numpy(),
                                   atol=TOL, err_msg=k)
    assert int(p["opt"]["count"]) == int(j["opt"]["count"]) == STEPS
    for k in j["opt"]["mu"]:
        np.testing.assert_allclose(p["opt"]["mu"][k].numpy(),
                                   j["opt"]["mu"][k].numpy(), atol=TOL,
                                   err_msg=k)
        # The second moment in the gradient's units.
        np.testing.assert_allclose(p["opt"]["nu"][k].sqrt().numpy(),
                                   j["opt"]["nu"][k].sqrt().numpy(),
                                   atol=TOL, err_msg=k)
