"""The first two distillation steps of the ``ghz6_auto`` recipe on the JAX
package's committed seed-0 data (``examples/reference_data/
ghz6_auto_seed0.npz``), the port against ``ddqst_tpu``, on the CPU.

GHZ-6 is the first rung whose distillation draws a minibatch of bases (96
of 729) each step. Both packages start from one set of parameters that the
port initialised (carried into JAX by ``params_to_flax``) and run the
recipe's distillation (held-out split of 15% of the shots, the counts
target, lr 1e-3, the held-out selection) for two steps; the port draws the
same bases as JAX: its ``torch.multinomial`` draw hands out the first rows
of the committed draws (``examples/reference_data/
ghz6_auto_draws_seed0.npz``, JAX's own, held against ``jax.random.choice``
in ``tests/test_torch_ghz6_witness.py``). The losses, the full-grid
chain CE before and after, the held-out history and the step it keeps, the
parameters and the Adam moments agree within ``TOL``. The width is cut to a
CPU test (embed 16, hidden 32, 1 block; T = 100 and the shapes otherwise).
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
from ddqst_tpu_torch.models import (build_model, chain_opt_from_flax,
                                    params_from_flax, params_to_flax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import run_scaling_ghz  # noqa: E402

torch.set_num_threads(1)

DATA = os.path.join(ROOT, "examples", "reference_data",
                    "ghz6_auto_seed0.npz")
DRAWS = os.path.join(ROOT, "examples", "reference_data",
                     "ghz6_auto_draws_seed0.npz")
TAG, N, STEPS = "ghz6_auto", 6, 2
TOL = 1e-5


def _cut(cfg):
    return cfg.replace(
        model=dataclasses.replace(cfg.model, embed_dim=16, hidden_dim=32,
                                  num_blocks=1),
        train=dataclasses.replace(cfg.train, chain_finetune_steps=STEPS))


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ghz6_distill")
    jc = _cut(next(c for t, c, _ in run_scaling_ghz.experiments()
                   if t == TAG))
    tc = _cut(scaling.experiment(TAG)[0])
    tr = jc.train
    assert tr.chain_basis_batch == 96 and tr.chain_val_fraction == 0.15
    t_steps = jc.diffusion.num_timesteps
    data = jpipe.load_data_cache(DATA)
    _, k_train, _ = jax.random.split(jax.random.key(0), 3)
    torch.manual_seed(0)
    sd = build_model(tc.model, N, t_steps).state_dict()
    ppath = str(tmp / "params.pt")
    torch.save(sd, ppath)
    state = jtrain.create_state(k_train, jbuild_model(jc.model, N, t_steps),
                                jc.train, N)
    state = state.replace(params=jax.tree_util.tree_map(
        jax.numpy.asarray, params_to_flax(sd)))

    # JAX: run_experiment's held-out split and distillation call
    # (ddqst_tpu/pipeline.py:677-737), on the file's data.
    key = jax.random.fold_in(k_train, 0xD157 + tr.chain_key_salt)
    s = data.bits.shape[1]
    s_val = min(max(int(round(tr.chain_val_fraction * s)), 1), s - 1)
    jstate, jlosses, jinfo = jtrain.finetune_chain(
        state, jmle.bits_to_counts(data.bits[:, :s - s_val]),
        jmake_schedule(jc.diffusion.schedule, t_steps), N, steps=STEPS,
        learning_rate=tr.chain_lr, exact=jc.diffusion.exact,
        basis_batch=tr.chain_basis_batch, key=key,
        steps_per_call=tr.chain_steps_per_call,
        val_counts=jmle.bits_to_counts(data.bits[:, s - s_val:]),
        val_patience=tr.chain_val_patience, accum=tr.chain_accum,
        hard_frac=tr.chain_hard_frac)
    leaves = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    jopt = jinfo.pop("final_opt_state")

    # JAX's draws: the committed file's first STEPS rows.
    with np.load(DRAWS) as f:
        draws = list(f["draws"][:STEPS])

    def multinomial(p, num, replacement=False, generator=None):
        assert num == tr.chain_basis_batch and not replacement
        return torch.from_numpy(draws.pop(0).astype(np.int64))

    out, opt = str(tmp / "distilled.pt"), str(tmp / "opt.pt")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "multinomial", multinomial)
        tres = tpipe.run_experiment(tc, seed=0, data_cache=DATA,
                                    params_load=ppath, params_save=out,
                                    opt_save=opt, stop_after="distill",
                                    device="cpu", log_fn=lambda m: None)
    assert draws == []
    return dict(
        jax=dict(losses=np.asarray(jlosses), info=jinfo,
                 params=params_from_flax(leaves(jstate.params)),
                 opt=chain_opt_from_flax(leaves(jopt))),
        port=dict(losses=tres["ft_losses"], info=tres["ft_info"],
                  params=torch.load(out, weights_only=True),
                  opt=torch.load(opt, weights_only=True)))


def test_minibatched_losses_chain_ce_and_held_out_choice_match_jax(steps):
    j, p = steps["jax"], steps["port"]
    assert len(p["losses"]) == len(j["losses"]) == STEPS
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=TOL)
    for k in ("train_ce_before", "train_ce_after", "best_val_ce"):
        assert p["info"][k] == pytest.approx(float(j["info"][k]), rel=TOL), k
    assert p["info"]["best_step"] == int(j["info"]["best_step"])
    assert [s for s, _ in p["info"]["val_history"]] == [
        int(s) for s, _ in j["info"]["val_history"]] == [0, STEPS]
    np.testing.assert_allclose([c for _, c in p["info"]["val_history"]],
                               [float(c) for _, c in j["info"]["val_history"]],
                               rtol=TOL)


def test_minibatched_parameters_and_adam_moments_match_jax(steps):
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
        np.testing.assert_allclose(p["opt"]["nu"][k].sqrt().numpy(),
                                   j["opt"]["nu"][k].sqrt().numpy(),
                                   atol=TOL, err_msg=k)
