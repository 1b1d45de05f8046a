"""Port parity: loss, optimizer updates and the training loop."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddqst_tpu.ops import diffusion as jdiff
from ddqst_tpu.ops import schedules as jsched
from ddqst_tpu_torch import train as ttrain
from ddqst_tpu_torch.config import TrainConfig
from ddqst_tpu_torch.models import d3pm as td3pm
from ddqst_tpu_torch.ops import diffusion as tdiff
from ddqst_tpu_torch.ops import schedules as tsched

# The suite runs in several xdist workers; one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)


def test_cross_entropy_matches_jax():
    """Same logits against the same x0: a denoiser that ignores its inputs
    makes both packages' denoising_loss deterministic."""
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(256, 3, 2)) * 2).astype(np.float32)
    x0 = rng.integers(0, 2, (256, 3)).astype(np.int8)
    basis = rng.integers(0, 27, 256).astype(np.int32)
    ref = jdiff.denoising_loss(
        jax.random.key(0), lambda x, t, b: jnp.asarray(logits),
        jnp.asarray(x0), jnp.asarray(basis), jsched.cosine_schedule(20))
    out = tdiff.denoising_loss(
        torch.Generator().manual_seed(0), lambda x, t, b: torch.from_numpy(logits),
        torch.from_numpy(x0), torch.from_numpy(basis), tsched.cosine_schedule(20))
    np.testing.assert_allclose(float(out), float(ref), atol=1e-6)


def test_q_sample_flip_rate():
    s = tsched.cosine_schedule(100)
    x0 = torch.zeros((40000, 3), dtype=torch.int8)
    t = torch.full((40000,), 50)
    xt = tdiff.q_sample(torch.Generator().manual_seed(0), x0, t, s)
    assert abs(float(xt.float().mean()) - float(s.cum_flip[50])) < 0.01


@pytest.mark.parametrize("optimizer", ["adam", "adamw", "sgd"])
def test_optimizer_steps_match_optax(optimizer):
    """Three updates on the same params and gradients (bias correction and
    optax.adamw's default weight decay 1e-4 included)."""
    rng = np.random.default_rng(1)
    p0 = {"w": rng.normal(size=(5, 4)).astype(np.float32),
          "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    lr = 1e-2
    tx = {"adam": optax.adam, "adamw": optax.adamw, "sgd": optax.sgd}[optimizer](lr)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = ttrain.make_optimizer(
        TrainConfig(optimizer=optimizer, learning_rate=lr), list(tp.values()))
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in g.items():
            tp[k].grad = torch.from_numpy(v)
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6)


def test_warmup_cosine_schedule_matches_optax():
    cfg = TrainConfig(learning_rate=1e-3, lr_schedule="cosine")
    total = 400
    ref = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=1e-3, warmup_steps=total // 20,
        decay_steps=total, end_value=1e-3 * 0.02)
    lr = ttrain.make_lr_schedule(cfg, total)
    for k in (0, 1, 7, 19, 20, 21, 150, 399, 400, 450):
        assert lr(k) == pytest.approx(float(ref(k)), rel=1e-5, abs=1e-10)
    assert ttrain.make_lr_schedule(TrainConfig(learning_rate=0.1), total)(9) == 0.1


def _tiny_data(rng, m=2048, n=2):
    basis = rng.integers(0, 3**n, m)
    bits = np.zeros((m, n), np.int8)
    bits[:, 0] = (basis % 3 == 0)  # a learnable basis-dependent bit
    bits[:, 1] = rng.integers(0, 2, m) * (basis % 2)
    return torch.from_numpy(bits), torch.from_numpy(basis)


@pytest.mark.parametrize("ema_decay", [0.0, 0.5])
def test_fit_lowers_loss(ema_decay):
    bits, basis = _tiny_data(np.random.default_rng(2))
    model = td3pm.ConditionalD3PM(2, 9, 10, embed_dim=8, hidden_dim=32,
                                  num_blocks=1, input_encoding="token")
    cfg = TrainConfig(batch_size=256, learning_rate=3e-3, optimizer="adam",
                      num_epochs=12, log_every=0, ema_decay=ema_decay,
                      eval_every=6)
    logs = []
    model, losses = ttrain.fit(
        torch.Generator().manual_seed(0), model, bits, basis, cfg,
        tsched.cosine_schedule(10), eval_bits=bits[:512], eval_basis=basis[:512],
        log_fn=logs.append, device="cpu")
    assert losses.shape == (12,)
    assert float(losses[-3:].mean()) < float(losses[:2].mean()) - 0.05
    assert sum("val loss" in m for m in logs) == 2
    vl = ttrain.eval_loss(model, torch.Generator().manual_seed(1), bits, basis,
                          tsched.cosine_schedule(10), 256)
    assert float(vl) < float(losses[0])


def test_fit_is_reproducible_from_its_generator():
    bits, basis = _tiny_data(np.random.default_rng(3), m=512)
    cfg = TrainConfig(batch_size=128, num_epochs=2, log_every=0)

    def run():
        m = td3pm.ConditionalD3PM(2, 9, 10, embed_dim=8, hidden_dim=16,
                                  num_blocks=1)
        m, losses = ttrain.fit(torch.Generator().manual_seed(5), m, bits, basis,
                               cfg, tsched.linear_schedule(10), device="cpu")
        return losses, [p.detach().clone() for p in m.parameters()]

    (l1, p1), (l2, p2) = run(), run()
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))


@pytest.mark.parametrize("change", [dict(checkpoint_dir="ckpt"),
                                    dict(data_axis=2)])
def test_fit_unported_options_raise(change, tmp_path, monkeypatch):
    """Both options once raised. Checkpoints are ported and write one at the
    end (``tests/test_torch_checkpoint.py`` holds resume); ``data_axis`` is
    not read, as the JAX package's ``fit`` never reads it (the mesh comes
    from ``mesh=``), so the run equals the default config's bit for bit."""
    bits, basis = _tiny_data(np.random.default_rng(4), m=64)
    cfg = dataclasses.replace(TrainConfig(num_epochs=1), **change)

    def run(cfg):
        m = td3pm.ConditionalD3PM(2, 9, 10, embed_dim=8, hidden_dim=16,
                                  num_blocks=1)
        return ttrain.fit(torch.Generator().manual_seed(0), m, bits, basis, cfg,
                          tsched.linear_schedule(10), device="cpu",
                          log_fn=lambda msg: None)

    if "checkpoint_dir" in change:
        monkeypatch.chdir(tmp_path)
        run(cfg)
        assert os.listdir(tmp_path / "ckpt") == ["1"]
        return
    (m1, l1), (m2, l2) = run(cfg), run(TrainConfig(num_epochs=1))
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(m1.parameters(),
                                                 m2.parameters()))


def test_profiling_trace_writes_a_trace_file(tmp_path):
    from ddqst_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    assert os.path.getsize(tmp_path / "prof" / files[0]) > 0
    assert any("mm" in e.key for e in prof.key_averages())


def test_profiling_timed_logs_a_line():
    from ddqst_tpu_torch.utils import profiling

    lines = []
    x = torch.ones(3)
    with profiling.timed("block", sync_on={"a": [x, (x,)]}, log_fn=lines.append):
        x.add_(1)
    assert len(lines) == 1 and lines[0].startswith("[timed] block: ")
    assert lines[0].endswith("s") and float(lines[0].split()[-1][:-1]) >= 0
