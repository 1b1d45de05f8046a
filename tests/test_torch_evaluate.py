"""Port parity: circuit conditioning, the circuit-conditioned grid sampler,
train_on_dataset and the evaluation harness against ddqst_tpu (CPU)."""

import csv
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddqst_tpu import evaluate as jev
from ddqst_tpu import pipeline as jpipe
from ddqst_tpu.config import get_preset as jpreset
from ddqst_tpu.data import generate as jgen
from ddqst_tpu.models import d3pm as jd3pm
from ddqst_tpu.ops import diffusion as jdiff
from ddqst_tpu.ops import metrics as jM
from ddqst_tpu.ops import mle as jmle
from ddqst_tpu.ops import pauli as jpauli
from ddqst_tpu.ops import schedules as jsched
from ddqst_tpu.ops.complexlib import from_complex
from ddqst_tpu_torch import evaluate as tev
from ddqst_tpu_torch import pipeline as tpipe
from ddqst_tpu_torch import train as ttrain
from ddqst_tpu_torch.config import get_preset as tpreset
from ddqst_tpu_torch.data import records as trec
from ddqst_tpu_torch.data.loader import dataset_to_training_arrays
from ddqst_tpu_torch.models import build_model, d3pm as td3pm, params_from_flax
from ddqst_tpu_torch.ops import diffusion as tdiff
from ddqst_tpu_torch.ops import schedules as tsched
from ddqst_tpu_torch.utils import checkpoint

# The suite runs in several xdist workers; one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)

T, C = 20, 3
WIDTH = dict(embed_dim=16, hidden_dim=32, num_blocks=2)


def _tv_bound(g, s):
    return 4 * np.sqrt(g / (2 * np.pi * s))


def _flax_and_port(n, num_circuits, seed=1, t_steps=T):
    fm = jd3pm.ConditionalD3PM(num_qubits=n, num_bases=3**n,
                               num_timesteps=t_steps, input_encoding="token",
                               num_circuits=num_circuits, **WIDTH)
    params = fm.init(jax.random.key(seed), jnp.zeros((2, n), jnp.int8),
                     jnp.ones((2,), jnp.int32),
                     jnp.zeros((2, 2), jnp.int32))["params"]
    return fm, params, _port_model(params, n, num_circuits, t_steps)


def _port_model(params, n, num_circuits, t_steps=T):
    tm = td3pm.ConditionalD3PM(n, 3**n, t_steps, input_encoding="token",
                               num_circuits=num_circuits, **WIDTH)
    tm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                               params)))
    return tm.eval()


def _port_records(recs):
    return [trec.CircuitRecord(**dataclasses.asdict(r)) for r in recs]


def _cfgs(conditioned):
    out = []
    for preset in (jpreset, tpreset):
        c = preset("rqc")
        out.append(c.replace(
            model=dataclasses.replace(c.model, condition_on_circuit=conditioned,
                                      **WIDTH),
            diffusion=dataclasses.replace(c.diffusion, num_timesteps=T,
                                          sampler="renoise"),
            train=dataclasses.replace(c.train, batch_size=512,
                                      learning_rate=2e-3, num_epochs=12,
                                      log_every=0, eval_every=0),
            data=dataclasses.replace(c.data, num_qubits=2),
        ))
    return out


@functools.lru_cache(maxsize=None)
def _dataset():
    """Five JAX-built N=2 circuits with all 9 bases."""
    return jgen.build_dataset(seed=0, num_samples=5, num_qubits=2,
                              min_depth=2, max_depth=4, shots=400,
                              noise_type="readout")


@functools.lru_cache(maxsize=None)
def _trained(conditioned):
    """JAX train_on_dataset on the first three circuits and its converted
    params in the port."""
    jcfg, _ = _cfgs(conditioned)
    state, eval_recs = jpipe.train_on_dataset(
        jcfg, _dataset()[:C], num_eval_circuits=C, seed=0,
        log_fn=lambda *a: None)
    return dict(conditioned=conditioned, state=state, eval_recs=eval_recs,
                model=_port_model(state.params, 2, C if conditioned else 0))


def _jax_exact_dist(state, conditioned, circuit):
    """JAX's exact chain distribution [9, 4], the circuit held fixed."""
    def fn(x, t, b):
        if conditioned:
            b = jnp.stack([b, jnp.full_like(b, circuit)], axis=-1)
        return state.apply_fn({"params": state.params}, x, t, b)

    return np.asarray(jdiff.chain_distribution(
        fn, 2, jsched.make_schedule("cosine", T), exact=False))


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("packed", [True, False])
def test_circuit_conditioned_logits_match_flax(n, packed):
    fm, params, tm = _flax_and_port(n, C)
    rng = np.random.default_rng(n)
    x = rng.integers(0, 2, (64, n)).astype(np.int8)
    t = rng.integers(0, T + 1, 64).astype(np.int32)
    basis = rng.integers(0, 3**n, 64).astype(np.int32)
    if packed:
        basis = np.stack([basis, rng.integers(0, C, 64).astype(np.int32)], -1)
    ref = np.asarray(fm.apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(t), jnp.asarray(basis)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t),
                 torch.from_numpy(basis)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    assert tm.blocks[0].film.in_features == 3 * WIDTH["embed_dim"]


def test_build_model_adds_circuit_embedding():
    cfg = tpreset("rqc").model
    assert not hasattr(build_model(cfg, 3, T), "circuit_emb")
    m = build_model(dataclasses.replace(cfg, condition_on_circuit=True), 3, T,
                    num_circuits=7)
    assert m.circuit_emb.weight.shape == (7, cfg.embed_dim)


def test_grid_enum_with_circuits_matches_jax():
    gx, gb = tdiff._grid_enum(2, "cpu", num_circuits=C)
    jx, jb = jdiff._grid_enum(2, C)
    assert gb.shape == (C * 36, 2)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(jb))


@pytest.mark.parametrize(
    "t_steps,row_budget",
    [(T, tdiff._ROW_BUDGET),  # one forward for all T
     (13, 250),               # prime T, m=2: padded with dummy t=1 rows
     (7, 100)],               # grid (108 rows) > budget: row-chunked
)
def test_grid_p1_tables_with_circuits_match_jax(t_steps, row_budget):
    fm, params, tm = _flax_and_port(2, C, t_steps=t_steps)

    def jfn(x, t, b):
        return fm.apply({"params": params}, x, t, b)

    ref = np.asarray(jdiff.grid_p1_tables(
        jfn, 2, jsched.cosine_schedule(t_steps), num_circuits=C))
    out = tdiff.grid_p1_tables(tm, 2, tsched.cosine_schedule(t_steps),
                               num_circuits=C, row_budget=row_budget).numpy()
    assert out.shape == ref.shape == (t_steps, C * 36, 2)
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("precompute", [True, False])
def test_p_sample_grid_with_circuits_matches_chain_distribution(precompute):
    """Per (circuit, basis), the port's samples lie within the shot-noise TV
    bound of JAX's exact chain distribution with that circuit held fixed."""
    trained = _trained(True)
    shots = 3000
    packed = torch.stack([torch.arange(9).repeat_interleave(shots).repeat(C),
                          torch.arange(C).repeat_interleave(9 * shots)], -1)
    out = tdiff.p_sample_grid(
        torch.Generator().manual_seed(5), trained["model"], packed, 2,
        tsched.cosine_schedule(T), exact=False, num_circuits=C,
        precompute=precompute)
    assert out.shape == (C * 9 * shots, 2) and out.dtype == torch.int8
    idx = (out.long() * torch.tensor([1, 2])).sum(-1).numpy()
    idx = idx.reshape(C, 9, shots)
    for c in range(C):
        exact = _jax_exact_dist(trained["state"], True, c)
        for b in range(9):
            emp = np.bincount(idx[c, b], minlength=4) / shots
            assert 0.5 * np.abs(emp - exact[b]).sum() < _tv_bound(4, shots)


@pytest.mark.parametrize("conditioned", [True, False])
def test_evaluate_dataset_matches_jax(conditioned, tmp_path):
    """Raw metrics equal JAX's harness on the same records; D3PM fidelities
    within 0.02 of the inversion of JAX's exact chain; JAX's CSV columns."""
    trained = _trained(conditioned)
    shots = 5000
    jout = jev.evaluate_dataset(
        jax.random.key(0), trained["eval_recs"], trained["state"].apply_fn,
        {"params": trained["state"].params}, 2, jsched.make_schedule("cosine", T),
        shots_infer=100, exact=False, circuit_conditioned=conditioned,
        out_dir=str(tmp_path / "jax"), log_fn=lambda *a: None)
    recs = _port_records(trained["eval_recs"])
    extras = {}
    out = tev.evaluate_dataset(
        torch.Generator().manual_seed(2), recs, trained["model"], 2,
        tsched.cosine_schedule(T), shots_infer=shots, exact=False,
        circuit_conditioned=conditioned, out_dir=str(tmp_path / "port"),
        log_fn=lambda *a: None, device="cpu", extras=extras)
    assert tuple(extras["samples"].shape) == (
        ((C,) if conditioned else ()) + (9, shots, 2))
    assert len(extras["rho_raw"]) == len(extras["rho_d3pm"]) == C
    assert len(out) == len(jout) == C
    for i, (a, r) in enumerate(zip(out, jout)):
        assert list(a) == list(r)
        assert (a["id"], a["depth"]) == (r["id"], r["depth"])
        for k in ("raw_fidelity", "raw_trace_distance"):
            assert a[k] == pytest.approx(r[k], abs=1e-5), k
        assert a["raw_entropy"] == pytest.approx(r["raw_entropy"], abs=1e-4)
        # D3PM fidelity against the inversion of JAX's exact chain.
        dist = _jax_exact_dist(trained["state"], trained["conditioned"], i)
        rho = jpauli.make_counts_inverter(2)(jnp.asarray(dist * shots))
        fid = float(jM.state_fidelity(from_complex(recs[i].clean_state), rho))
        assert abs(a["d3pm_fidelity"] - fid) < 0.02, (i, a["d3pm_fidelity"], fid)
    with open(tmp_path / "port" / "metrics.csv") as f, \
            open(tmp_path / "jax" / "metrics.csv") as g:
        assert next(csv.reader(f)) == next(csv.reader(g))
    assert os.path.exists(tmp_path / "port" / "fidelity_lift.png")
    assert os.path.exists(tmp_path / "port" / "universality.png")


def _capped(rec, rows):
    return dataclasses.replace(rec, basis_labels=rec.basis_labels[rows],
                               counts=rec.counts[rows])


def test_evaluate_dataset_unported_options_raise():
    """MLE reconstruction and records with fewer than 3^N bases run (they
    raised until the estimators were ported); an unknown method raises."""
    recs = _port_records(_dataset()[:1])
    model = td3pm.ConditionalD3PM(2, 9, T, input_encoding="token", **WIDTH)
    sched = tsched.cosine_schedule(T)
    gen = torch.Generator().manual_seed(0)
    quiet = dict(device="cpu", log_fn=lambda *a: None)
    (row,) = tev.evaluate_dataset(gen, recs, model, 2, sched, shots_infer=50,
                                  reconstruction="mle", **quiet)
    assert 0 < row["raw_fidelity"] <= 1.001
    (row,) = tev.evaluate_dataset(gen, [_capped(recs[0], slice(0, 4))], model,
                                  2, sched, shots_infer=50, **quiet)
    assert 0 <= row["raw_fidelity"] <= 1.001
    with pytest.raises(ValueError):
        tev.evaluate_dataset(gen, recs, model, 2, sched, shots_infer=50,
                             reconstruction="bayes", **quiet)


@pytest.mark.parametrize("reconstruction,rows,readout_p", [
    ("mle", None, 0.0),
    ("mle", None, 0.01),
    ("mle", [0, 2, 4, 5, 8], 0.01),
    ("linear", [0, 2, 4, 5, 8], 0.01),
])
def test_evaluate_dataset_estimators_match_jax(reconstruction, rows,
                                               readout_p):
    """Raw metrics equal JAX's harness with the same estimator on the same
    records (1e-4: the MLE fidelity tolerance; 1e-5 for the dense linear
    inverter), also for records measured on five of the nine bases; the
    D3PM fidelity lies within 0.02 of the same estimator on JAX's exact
    chain distribution."""
    trained = _trained(False)
    shots = 4000
    jrecs = trained["eval_recs"]
    if rows is not None:
        jrecs = [_capped(r, rows) for r in jrecs]
    kw = dict(exact=False, reconstruction=reconstruction, readout_p=readout_p,
              log_fn=lambda *a: None)
    jout = jev.evaluate_dataset(
        jax.random.key(0), jrecs, trained["state"].apply_fn,
        {"params": trained["state"].params}, 2,
        jsched.make_schedule("cosine", T), shots_infer=100, **kw)
    out = tev.evaluate_dataset(
        torch.Generator().manual_seed(4), _port_records(jrecs),
        trained["model"], 2, tsched.cosine_schedule(T), shots_infer=shots,
        device="cpu", **kw)
    tol = 1e-4 if reconstruction == "mle" else 1e-5
    dist = _jax_exact_dist(trained["state"], False, 0)
    make = (jmle.make_mle if reconstruction == "mle"
            else jpauli.make_counts_inverter)
    rho = make(2, readout_p=readout_p)(jnp.asarray(dist * shots))
    for a, r, rec in zip(out, jout, jrecs):
        assert a["raw_fidelity"] == pytest.approx(r["raw_fidelity"], abs=tol)
        assert a["raw_trace_distance"] == pytest.approx(
            r["raw_trace_distance"], abs=10 * tol)
        fid = float(jM.state_fidelity(from_complex(rec.clean_state), rho))
        assert abs(a["d3pm_fidelity"] - fid) < 0.02


def test_train_on_dataset_matches_jax_eval_subset(tmp_path):
    """Same seed, same shuffle: the eval subset is the same circuits as
    JAX's (the first num_eval_circuits training circuits), the loss drops,
    and the promised files exist."""
    dataset = _dataset()
    jcfg, tcfg = _cfgs(True)
    tcfg = tcfg.replace(train=dataclasses.replace(tcfg.train, num_epochs=4))
    _, j_eval = jpipe.train_on_dataset(
        jcfg.replace(train=dataclasses.replace(jcfg.train, num_epochs=1)),
        dataset, num_eval_circuits=2, train_ratio=0.8, seed=7,
        log_fn=lambda *a: None)
    model, t_eval = tpipe.train_on_dataset(
        tcfg, _port_records(dataset), save_dir=str(tmp_path), run_name="m",
        num_eval_circuits=2, train_ratio=0.8, seed=7, log_fn=lambda *a: None,
        device="cpu")
    assert [r.id for r in t_eval] == [r.id for r in j_eval]
    assert model.circuit_emb.weight.shape[0] == 4  # int(5 * 0.8) circuits
    saved = trec.load_shard(str(tmp_path / "m_eval.npz"))
    assert [r.hash for r in saved] == [r.hash for r in t_eval]

    arrays = dataset_to_training_arrays(t_eval)
    cond = torch.stack([arrays["basis_idx"], arrays["circuit_idx"]], -1)
    sched = tsched.cosine_schedule(T)

    def loss(m):
        return float(ttrain.eval_loss(m, torch.Generator().manual_seed(0),
                                      arrays["bits"].long(), cond.long(),
                                      sched, 512))

    fresh = build_model(tcfg.model, 2, T, num_circuits=4)
    td3pm.init_params_(fresh, torch.Generator().manual_seed(0))
    assert loss(model) < loss(fresh.eval())

    back = checkpoint.restore_params(str(tmp_path / "m_params.pt"),
                                     build_model(tcfg.model, 2, T, 4))
    assert all(torch.equal(a, b) for a, b in zip(back.state_dict().values(),
                                                 model.state_dict().values()))
    with pytest.raises(RuntimeError):  # a circuit vocabulary of another size
        checkpoint.restore_params(str(tmp_path / "m_params.pt"),
                                  build_model(tcfg.model, 2, T, 3))


@pytest.mark.parametrize("n", [2, 3])
def test_create_sanity_records_matches_jax(n):
    (a,) = tpipe.create_sanity_records(n)
    (b,) = jpipe.create_sanity_records(n)
    for f in ("id", "hash", "depth"):
        assert getattr(a, f) == getattr(b, f)
    for f in ("clean_state", "basis_labels", "counts"):
        va, vb = getattr(a, f), getattr(b, f)
        assert va.dtype == vb.dtype
        np.testing.assert_array_equal(va, vb)
