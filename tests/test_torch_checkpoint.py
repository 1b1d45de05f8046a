"""Training checkpoints and resume in the port (CPU): the checkpoint
manager's round trip and retention, and ``fit``'s resume, which must equal
the uninterrupted run bit for bit."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ddqst_tpu_torch import cli
from ddqst_tpu_torch import train as ttrain
from ddqst_tpu_torch.config import TrainConfig
from ddqst_tpu_torch.models import d3pm as td3pm
from ddqst_tpu_torch.ops import schedules as tsched
from ddqst_tpu_torch.utils import checkpoint as ckpt

# The suite runs in several xdist workers; one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)


def test_checkpoint_round_trip_latest_step_and_retention(tmp_path):
    d = str(tmp_path / "ck")
    assert ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(d)
    gen = torch.Generator().manual_seed(3)
    for step in (1, 2, 3, 4, 5):
        state = {"w": torch.full((2, 3), float(step)), "step": step * 10,
                 "nested": {"g": gen.get_state()}}
        assert ckpt.save_checkpoint(d, state, step)
    assert ckpt.latest_step(d) == 5
    assert sorted(os.listdir(d)) == ["3", "4", "5"]  # the 3 newest kept
    got, step = ckpt.restore_checkpoint(d)
    assert step == 5 and got["step"] == 50
    assert torch.equal(got["w"], torch.full((2, 3), 5.0))
    assert torch.equal(got["nested"]["g"], gen.get_state())
    got, step = ckpt.restore_checkpoint(d, step=3)
    assert step == 3 and got["step"] == 30
    # A step at or below the newest is not written again (orbax's rule).
    assert not ckpt.save_checkpoint(d, {"w": torch.zeros(1)}, 5)
    assert not ckpt.save_checkpoint(d, {"w": torch.zeros(1)}, 2)
    assert ckpt.restore_checkpoint(d)[0]["step"] == 50
    # A half-written step (no checkpoint file) is not a checkpoint.
    os.makedirs(os.path.join(d, "9"))
    assert ckpt.latest_step(d) == 5


def _fit(cfg, seed=5):
    bits = torch.from_numpy(
        np.random.default_rng(0).integers(0, 2, (128, 2)).astype(np.int8))
    basis = torch.from_numpy(np.random.default_rng(1).integers(0, 9, 128))
    model = td3pm.ConditionalD3PM(num_qubits=2, num_bases=9, num_timesteps=8,
                                  embed_dim=8, hidden_dim=32, num_blocks=1)
    model, losses = ttrain.fit(torch.Generator().manual_seed(seed), model,
                               bits, basis, cfg, tsched.cosine_schedule(8),
                               device="cpu", log_fn=lambda m: None)
    return model, losses


def test_resume_equals_the_uninterrupted_run_bit_for_bit(tmp_path):
    """3 epochs with checkpoints, then a resume to 5, give the parameters
    and the last 2 losses of 5 uninterrupted epochs, bit for bit; the
    restored step counts optimiser steps (``tests/test_phase1.py``'s
    ``int(state2.step) == 5 * (128 // 64)``)."""
    ckdir = str(tmp_path / "ck")
    cfg1 = TrainConfig(batch_size=64, num_epochs=3, optimizer="adam",
                       learning_rate=1e-3, log_every=0, eval_every=0,
                       checkpoint_dir=ckdir, checkpoint_every=1)
    _, losses1 = _fit(cfg1)
    assert ckpt.latest_step(ckdir) == 3 and losses1.shape == (3,)
    cfg2 = dataclasses.replace(cfg1, num_epochs=5, resume=True)
    resumed, losses2 = _fit(cfg2, seed=99)  # the generator state is restored
    assert losses2.shape[0] == 2  # only the remaining epochs ran
    state, step = ckpt.restore_checkpoint(ckdir)
    assert step == 5 and state["step"] == 5 * (128 // 64)
    assert sorted(os.listdir(ckdir)) == ["3", "4", "5"]

    whole, losses = _fit(dataclasses.replace(cfg1, num_epochs=5,
                                             checkpoint_dir=""))
    assert torch.equal(losses2, losses[3:])
    for (k, a), b in zip(whole.state_dict().items(),
                         resumed.state_dict().values()):
        assert torch.equal(a, b), k


def test_resume_with_ema_starts_the_average_afresh(tmp_path):
    """The EMA is not saved: a resumed run averages only its own epochs,
    as the JAX package's does."""
    ckdir = str(tmp_path / "ck")
    cfg = TrainConfig(batch_size=64, num_epochs=2, optimizer="adam",
                      learning_rate=1e-3, log_every=0, eval_every=0,
                      checkpoint_dir=ckdir, checkpoint_every=1,
                      ema_decay=0.5)
    _fit(cfg)
    # Epoch 2 was saved before the EMA replaced the parameters, so the
    # end's save of step 2 is skipped and the raw parameters are kept.
    raw = ckpt.restore_checkpoint(ckdir)[0]["model"]
    resumed, _ = _fit(dataclasses.replace(cfg, num_epochs=3, resume=True))
    # One epoch of EMA from zero, debiased: the parameters after epoch 3.
    after3 = ckpt.restore_checkpoint(ckdir)[0]["model"]
    for k, v in resumed.state_dict().items():
        torch.testing.assert_close(v, after3[k], rtol=1e-6, atol=1e-6)
    assert any(not torch.equal(raw[k], after3[k]) for k in raw)


def test_resume_without_a_checkpoint_trains_from_scratch(tmp_path):
    cfg = TrainConfig(batch_size=64, num_epochs=2, optimizer="adam",
                      log_every=0, eval_every=0,
                      checkpoint_dir=str(tmp_path / "none"), resume=True)
    _, losses = _fit(cfg)
    assert losses.shape == (2,)
    assert ckpt.latest_step(cfg.checkpoint_dir) == 2  # the end's save


def test_cli_checkpoint_dir_and_resume(tmp_path, capsys):
    ckdir = str(tmp_path / "ck")
    args = ["run", "--preset", "rqc", "--num_qubits", "2", "--embed_dim", "8",
            "--hidden_dim", "16", "--num_blocks", "1", "--timesteps", "8",
            "--shots_train", "64", "--shots_infer", "64", "--batch_size", "64",
            "--checkpoint_dir", ckdir, "--checkpoint_every", "1",
            "--device", "cpu"]
    assert cli.main(args + ["--epochs", "2"]) == 0
    assert ckpt.latest_step(ckdir) == 2
    assert cli.main(args + ["--epochs", "3", "--resume"]) == 0
    assert "resumed from checkpoint at epoch 2" in capsys.readouterr().out
    assert ckpt.latest_step(ckdir) == 3
