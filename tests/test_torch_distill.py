"""Port parity: exact-chain distillation (train.finetune_chain), its Adam
state and the snapshots of that state, against ddqst_tpu on the same weights
and counts (CPU)."""

import inspect

import jax
import numpy as np
import pytest
import torch

from ddqst_tpu import train as jtrain
from ddqst_tpu.config import TrainConfig
from ddqst_tpu.models import d3pm as jd3pm
from ddqst_tpu.ops import schedules as jsched
from ddqst_tpu_torch import train as ttrain
from ddqst_tpu_torch.models import d3pm as td3pm, params_from_flax
from ddqst_tpu_torch.ops import pauli as tpauli
from ddqst_tpu_torch.ops import schedules as tsched
from ddqst_tpu_torch.qsim.noise import confusion_matrix
from ddqst_tpu_torch.utils import checkpoint

# The suite runs in several xdist workers; one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)

N, T = 2, 8
B, G = 3**N, 2**N
WIDTH = dict(embed_dim=8, hidden_dim=32, num_blocks=2)
RTOL = 1e-4  # losses, CEs and Adam moments, relative, against JAX


def _state():
    fm = jd3pm.ConditionalD3PM(num_qubits=N, num_bases=B, num_timesteps=T,
                               input_encoding="token", **WIDTH)
    return jtrain.create_state(jax.random.key(1), fm, TrainConfig(), N)


def _port_model(params):
    tm = td3pm.ConditionalD3PM(N, B, T, input_encoding="token", **WIDTH)
    tm.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return tm


def _counts(seed, shots):
    """``[B, G]`` multinomial counts; one seed gives one set of per-basis
    distributions, so a target and its held-out counts share theirs."""
    probs = np.random.default_rng(seed).dirichlet(np.ones(G), size=B)
    rng = np.random.default_rng([seed, shots])
    return np.stack([rng.multinomial(shots, q) for q in probs]).astype(
        np.float32)


def _tree(params):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, params))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.fixture(scope="module")
def full_batch():
    """12 full-batch steps with a held-out split, evaluated every 3 steps,
    patience 2: the run stops early and selects an earlier step."""
    state = _state()
    tgt, val = _counts(0, 300), _counts(0, 60)
    kw = dict(steps=12, learning_rate=1e-3, exact=False, val_counts=val,
              steps_per_call=3, val_patience=2)
    jst, jl, ji = jtrain.finetune_chain(
        state, tgt, jsched.cosine_schedule(T), N, **kw)
    model, tl, ti = ttrain.finetune_chain(
        _port_model(state.params), tgt, tsched.cosine_schedule(T), N,
        device="cpu", **kw)
    return dict(jst=jst, jl=np.asarray(jl), ji=ji, model=model,
                tl=tl.numpy(), ti=ti)


def test_full_batch_losses_match_jax(full_batch):
    assert full_batch["tl"].shape == full_batch["jl"].shape
    assert _rel(full_batch["tl"], full_batch["jl"]) < RTOL
    assert full_batch["tl"][-1] < full_batch["tl"][0]


def test_full_grid_ce_before_and_after_match_jax(full_batch):
    ti, ji = full_batch["ti"], full_batch["ji"]
    for k in ("train_ce_before", "train_ce_after"):
        assert ti[k] == pytest.approx(ji[k], rel=RTOL), k
    assert ti["train_ce_after"] < ti["train_ce_before"]


def test_held_out_history_and_selection_match_jax(full_batch):
    ti, ji = full_batch["ti"], full_batch["ji"]
    assert [s for s, _ in ti["val_history"]] == \
        [s for s, _ in ji["val_history"]]
    assert _rel([c for _, c in ti["val_history"]],
                [c for _, c in ji["val_history"]]) < RTOL
    assert ti["best_step"] == ji["best_step"]
    assert 0 < ti["best_step"] < ti["val_history"][-1][0]
    assert ti["best_val_ce"] == pytest.approx(ji["best_val_ce"], rel=RTOL)
    assert ti["best_val_ce"] == min(c for _, c in ti["val_history"])


def test_selected_params_match_jax(full_batch):
    ref = _tree(full_batch["jst"].params)
    got = dict(full_batch["model"].named_parameters())
    assert got.keys() == ref.keys()
    for k, p in got.items():
        assert _rel(p.detach(), ref[k]) < RTOL, k
    assert not full_batch["model"].training


def test_final_opt_state_matches_jax(full_batch):
    """The Adam state after the LAST step (not the selected one), through
    the converter that relabels a flax tree."""
    got, ref = full_batch["ti"]["final_opt_state"], \
        full_batch["ji"]["final_opt_state"]
    assert int(got["count"]) == int(ref["count"]) == len(full_batch["tl"])
    for key in ("mu", "nu"):
        want = _tree(ref[key])
        assert got[key].keys() == want.keys()
        for k in want:
            assert _rel(got[key][k], want[k]) < RTOL, (key, k)


def test_confusion_in_the_loss_matches_jax():
    state = _state()
    tgt = _counts(2, 400)
    conf = confusion_matrix(N, 0.03)
    kw = dict(steps=4, learning_rate=1e-3, exact=True, confusion=conf)
    _, jl, ji = jtrain.finetune_chain(state, tgt, jsched.cosine_schedule(T), N,
                                      **kw)
    _, tl, ti = ttrain.finetune_chain(
        _port_model(state.params), tgt, tsched.cosine_schedule(T), N,
        device="cpu", **kw)
    assert _rel(tl.numpy(), np.asarray(jl)) < RTOL
    assert ti["train_ce_after"] == pytest.approx(ji["train_ce_after"],
                                                 rel=RTOL)
    assert "val_history" not in ti and "hard_draw_p" not in ti


def test_hard_draw_p_matches_jax():
    """The mining distribution comes from the entry per-basis CE alone, so
    it is deterministic: within 1e-6 of JAX's."""
    state = _state()
    tgt = _counts(3, 500)
    kw = dict(steps=1, learning_rate=1e-3, exact=False, basis_batch=3,
              hard_frac=0.6)
    _, _, ji = jtrain.finetune_chain(state, tgt, jsched.cosine_schedule(T), N,
                                     **kw)
    _, _, ti = ttrain.finetune_chain(
        _port_model(state.params), tgt, tsched.cosine_schedule(T), N,
        device="cpu", **kw)
    assert ti["hard_draw_p"].shape == (B,)
    np.testing.assert_allclose(ti["hard_draw_p"], ji["hard_draw_p"], atol=1e-6)
    assert ti["hard_draw_p"].sum() == pytest.approx(1.0, abs=1e-6)
    assert ti["hard_draw_p"].min() >= (1 - 0.6) / B - 1e-6


def _record_draws(monkeypatch):
    draws = []
    real = torch.multinomial

    def spy(p, k, **kw):
        out = real(p, k, **kw)
        draws.append((out.clone(), kw))
        return out

    monkeypatch.setattr(torch, "multinomial", spy)
    return draws


@pytest.mark.parametrize("accum,hard_frac", [(1, 0.0), (2, 0.0), (2, 0.5)])
def test_minibatches_are_disjoint_draws_and_descend(accum, hard_frac,
                                                    monkeypatch):
    """Each step draws accum·basis_batch bases at once, without replacement
    (so the accum minibatches are disjoint), from the caller's generator;
    the full-grid CE falls."""
    draws = _record_draws(monkeypatch)
    tgt = _counts(4, 500)
    gen = torch.Generator().manual_seed(3)
    _, losses, info = ttrain.finetune_chain(
        _port_model(_state().params), tgt, tsched.cosine_schedule(T), N,
        steps=14, learning_rate=2e-3, exact=False, basis_batch=3, accum=accum,
        hard_frac=hard_frac, generator=gen, device="cpu")
    assert len(draws) == losses.shape[0] == 14
    for sel, kw in draws:
        assert kw["replacement"] is False and kw["generator"] is gen
        assert sel.shape == (accum * 3,)
        assert len(set(sel.tolist())) == accum * 3
    assert len({tuple(sel.tolist()) for sel, _ in draws}) > 1
    assert info["train_ce_after"] < info["train_ce_before"]
    assert ("hard_draw_p" in info) == (hard_frac > 0)


def test_accum_is_clamped_to_the_basis_set(monkeypatch):
    draws = _record_draws(monkeypatch)
    ttrain.finetune_chain(
        _port_model(_state().params), _counts(4, 500),
        tsched.cosine_schedule(T), N, steps=2, basis_batch=4, accum=5,
        device="cpu")
    assert [sel.shape for sel, _ in draws] == [(8,), (8,)]  # 9 // 4 = 2


def test_same_generator_seed_repeats_a_minibatched_run():
    def run(seed):
        return ttrain.finetune_chain(
            _port_model(_state().params), _counts(4, 500),
            tsched.cosine_schedule(T), N, steps=5, basis_batch=3,
            generator=torch.Generator().manual_seed(seed), device="cpu")[1]

    assert torch.equal(run(7), run(7))
    assert not torch.equal(run(7), run(8))


def test_held_out_cadence_in_full_grid_equivalent_steps_matches_jax():
    """Minibatches of 3 of 9 bases count a third of a step each: with chunks
    of 2 steps the held-out CE is looked at every 6 steps and at the last,
    at the step numbers JAX looks at it (the draws differ, the steps do
    not)."""
    state = _state()
    tgt, val = _counts(5, 500), _counts(5, 100)
    kw = dict(steps=15, learning_rate=1e-4, exact=False, basis_batch=3,
              val_counts=val, steps_per_call=2, val_patience=100)
    _, _, ji = jtrain.finetune_chain(state, tgt, jsched.cosine_schedule(T), N,
                                     **kw)
    _, _, ti = ttrain.finetune_chain(
        _port_model(state.params), tgt, tsched.cosine_schedule(T), N,
        device="cpu", **kw)
    steps = [s for s, _ in ti["val_history"]]
    assert steps == [s for s, _ in ji["val_history"]] == [0, 6, 12, 15]
    assert ti["val_history"][0][1] == pytest.approx(ji["val_history"][0][1],
                                                    rel=RTOL)


def test_init_opt_state_round_trip(tmp_path):
    """3 + 3 steps, the Adam state carried through a snapshot on disk, equal
    6 steps; and JAX resumed from the same state takes the same steps."""
    state = _state()
    tgt = _counts(7, 400)
    sched = tsched.cosine_schedule(T)

    def run(model, steps, init=None):
        return ttrain.finetune_chain(model, tgt, sched, N, steps=steps,
                                     learning_rate=1e-3, exact=False,
                                     init_opt_state=init, device="cpu")

    _, whole, _ = run(_port_model(state.params), 6)
    model, first, info = run(_port_model(state.params), 3)
    path = str(tmp_path / "opt.pt")
    checkpoint.save_chain_opt(path, info["final_opt_state"])
    back = checkpoint.restore_chain_opt(path, ttrain.chain_opt_template(model))
    assert int(back["count"]) == 3
    for key in ("mu", "nu"):
        for k, v in info["final_opt_state"][key].items():
            assert torch.equal(back[key][k], v)
    _, second, info2 = run(model, 3, init=back)
    np.testing.assert_allclose(torch.cat([first, second]).numpy(),
                               whole.numpy(), rtol=1e-6)
    assert int(info2["final_opt_state"]["count"]) == 6

    jst, _, ji = jtrain.finetune_chain(
        state, tgt, jsched.cosine_schedule(T), N, steps=3, learning_rate=1e-3,
        exact=False)
    _, jl2, _ = jtrain.finetune_chain(
        jst, tgt, jsched.cosine_schedule(T), N, steps=3, learning_rate=1e-3,
        exact=False, init_opt_state=ji["final_opt_state"])
    assert _rel(second.numpy(), np.asarray(jl2)) < RTOL


def test_chain_opt_template_and_strict_restore(tmp_path):
    model = _port_model(_state().params)
    tpl = ttrain.chain_opt_template(model)
    assert set(tpl) == {"count", "mu", "nu"} and int(tpl["count"]) == 0
    names = [k for k, _ in model.named_parameters()]
    for key in ("mu", "nu"):
        assert list(tpl[key]) == names
        assert all(float(v.abs().sum()) == 0 and v.shape == p.shape
                   for v, p in zip(tpl[key].values(), model.parameters()))
    path = str(tmp_path / "opt.pt")
    checkpoint.save_chain_opt(path, tpl)
    checkpoint.restore_chain_opt(path, tpl)
    wider = td3pm.ConditionalD3PM(N, B, T, input_encoding="token",
                                  **{**WIDTH, "hidden_dim": 16})
    with pytest.raises(RuntimeError, match="shape"):
        checkpoint.restore_chain_opt(path, ttrain.chain_opt_template(wider))
    deeper = td3pm.ConditionalD3PM(N, B, T, input_encoding="token",
                                   **{**WIDTH, "num_blocks": 3})
    with pytest.raises(RuntimeError, match="names"):
        checkpoint.restore_chain_opt(path, ttrain.chain_opt_template(deeper))
    with pytest.raises(ValueError):
        ttrain.finetune_chain(deeper, _counts(0, 50),
                              tsched.cosine_schedule(T), N, steps=1,
                              init_opt_state=tpl, device="cpu")


class _ByLabels(torch.nn.Module):
    """The token denoiser behind a label-row interface: ``[R, N]`` labels
    are folded to the canonical basis index (qubit 0 slowest)."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x, t, labels):
        idx = (labels * (3 ** torch.arange(N - 1, -1, -1))).sum(-1)
        return self.inner(x, t, idx)


def test_basis_labels_distil_exactly_those_rows():
    """Over label rows the run equals the canonical one restricted to the
    same bases: same losses, same CE, and minibatches draw label rows."""
    state = _state()
    rows = [7, 2, 5, 0]
    labels = tpauli.all_basis_labels(N)[rows]
    tgt, val = _counts(8, 300), _counts(8, 80)
    sched = tsched.cosine_schedule(T)
    kw = dict(steps=4, learning_rate=1e-3, exact=False, steps_per_call=2,
              device="cpu")
    _, ref, ref_info = ttrain.finetune_chain(
        _ByLabels(_port_model(state.params)), tgt[rows], sched, N,
        val_counts=val[rows], basis_labels=labels, **kw)
    assert [s for s, _ in ref_info["val_history"]] == [0, 2, 4]

    # The same objective written with basis_idx, by hand.
    from ddqst_tpu_torch.ops.diffusion import chain_distribution
    model = _port_model(state.params)
    t_rows = torch.from_numpy(tgt[rows])
    t_rows = t_rows / t_rows.sum(-1, keepdim=True)
    dist = chain_distribution(model, N, sched, False,
                              basis_idx=torch.tensor(rows))
    ce = -(t_rows * dist.clamp_min(1e-12).log()).sum(-1).mean()
    assert float(ref[0]) == pytest.approx(float(ce.detach()), rel=1e-6)
    assert ref_info["train_ce_before"] == pytest.approx(float(ce.detach()),
                                                        rel=1e-6)
    _, mini, info = ttrain.finetune_chain(
        _ByLabels(_port_model(state.params)), tgt[rows], sched, N,
        basis_labels=labels, basis_batch=2, **kw)
    assert mini.shape == (4,) and np.isfinite(info["train_ce_after"])


def test_zero_steps_leave_the_model_alone():
    state = _state()
    model = _port_model(state.params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, losses, info = ttrain.finetune_chain(
        model, _counts(0, 100), tsched.cosine_schedule(T), N, steps=0,
        device="cpu")
    assert losses.shape == (0,)
    assert info["train_ce_after"] == pytest.approx(info["train_ce_before"])
    assert int(info["final_opt_state"]["count"]) == 0
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())


def test_finetune_chain_reads_no_environment_variable(monkeypatch):
    """The JAX package's fallback knobs are not the port's."""
    monkeypatch.setenv("DDQST_SKIP_GRID_CE", "1")
    monkeypatch.setenv("DDQST_GRID_ROWS", "1")
    _, _, info = ttrain.finetune_chain(
        _port_model(_state().params), _counts(0, 100),
        tsched.cosine_schedule(T), N, steps=1, val_counts=_counts(0, 50),
        device="cpu")
    assert np.isfinite(info["train_ce_before"])
    assert np.isfinite(info["train_ce_after"]) and "val_history" in info
    src = inspect.getsource(ttrain)
    assert "environ" not in src and "getenv" not in src


def test_finetune_chain_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ttrain.finetune_chain(_port_model(_state().params), _counts(0, 100),
                              tsched.cosine_schedule(T), N, steps=1)
