"""The scaling ladder's full canonical-grid route at N = 5 on the CPU: the
port's run_experiment over all 243 bases (factored MLE, the MLE-projected
distillation target, both generation paths, the segment protocol), from one
JAX-written data cache and JAX parameters, against ddqst_tpu; and the launch
plan of each rung's generation (N = 5 to 8) with a stub denoiser.

The widths are cut to a CPU test (embed 16, hidden 32, 1 block, T = 10,
40 training shots a basis). Every MLE solve, in both packages, is capped at
``MLE_ITERS`` iterations: at N = 5 a solve to its tolerance takes about
1,500 iterations, 25-70 s on one core, and the comparisons hold the
arithmetic of each iteration, which a fixed count shows as well.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddqst_tpu import config as jcfg
from ddqst_tpu import pipeline as jpipe
from ddqst_tpu import train as jtrain
from ddqst_tpu.models import build_model as jbuild_model
from ddqst_tpu.ops import diffusion as jdiff
from ddqst_tpu.ops import metrics as jM
from ddqst_tpu.ops import mle as jmle
from ddqst_tpu.ops import pauli as jpauli
from ddqst_tpu.ops.complexlib import CArray, from_complex, to_complex
from ddqst_tpu.ops.schedules import make_schedule as jmake_schedule
from ddqst_tpu.qsim import measure as jmeasure
from ddqst_tpu_torch import config as tcfg
from ddqst_tpu_torch import pipeline as tpipe
from ddqst_tpu_torch.models import build_model as tbuild_model
from ddqst_tpu_torch.models import params_from_flax
from ddqst_tpu_torch.ops import cuda_kernels as ck
from ddqst_tpu_torch.ops import diffusion as tdiff
from ddqst_tpu_torch.ops import mle as tmle
from ddqst_tpu_torch.ops.schedules import make_schedule as tmake_schedule
from ddqst_tpu_torch.utils.checkpoint import restore_params

# The suite runs in several xdist workers; one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)

N, T = 5, 10
B, G = 3**N, 2**N
SHOTS_INFER = 1000
MLE_ITERS = 30
RHO_ATOL = 2e-4  # per entry of ρ, as tests/test_torch_mle.py holds the MLE
FID_ATOL = 1e-4  # a fidelity after MLE, as tests/test_torch_mle.py
PROB_ATOL = 1e-5  # Born probabilities and the raw (linear) fidelity
PARAM_ATOL = 1e-5  # parameters after two distillation steps


def _cfg(mod, **train):
    """The ``ghz5_auto`` recipe's stack (scripts/run_parity_suite.py:60-81,
    scripts/run_scaling_ghz.py:46-66) at CPU-test widths and depth."""
    base = mod.get_preset("rqc")
    return base.replace(
        name="ghz5_small",
        model=dataclasses.replace(base.model, embed_dim=16, hidden_dim=32,
                                  num_blocks=1),
        diffusion=type(base.diffusion)(num_timesteps=T, schedule="cosine",
                                       sampler="renoise"),
        train=type(base.train)(batch_size=1024, learning_rate=1e-3,
                               optimizer="adam", num_epochs=1,
                               lr_schedule="cosine", log_every=0,
                               eval_every=0, chain_lr=1e-3, **train),
        data=type(base.data)(num_qubits=N, state_type="ghz",
                             noise_type="readout", shots_train=40,
                             shots_infer=SHOTS_INFER, mitigate_readout=True,
                             mitigate_train_data=True, reconstruction="mle"),
    )


def _capped(make):
    @functools.wraps(make)
    def wrapper(*args, **kw):
        kw["iterations"] = MLE_ITERS
        return make(*args, **kw)
    return wrapper


@pytest.fixture(scope="module")
def ladder(tmp_path_factory):
    """The JAX data cache and JAX parameters; the port's eval role (the full
    tail, no distillation) and a two-step full-batch distillation role
    against the MLE target, both from them; the JAX values they answer
    to."""
    tmp = tmp_path_factory.mktemp("scaling")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmle, "make_mle", _capped(tmle.make_mle))
        mp.setattr(jmle, "make_mle", _capped(jmle.make_mle))
        jc = _cfg(jcfg)
        k_data, k_train, _ = jax.random.split(jax.random.key(0), 3)
        data = jpipe.generate_training_data(jc, k_data,
                                            np.random.default_rng(0))
        cache = str(tmp / "data.npz")
        jpipe.save_data_cache(cache, data)
        state = jtrain.create_state(k_train, jbuild_model(jc.model, N, T),
                                    jc.train, N)
        ppath = str(tmp / "params.pt")
        torch.save(params_from_flax(
            jax.tree_util.tree_map(np.asarray, state.params)), ppath)

        # JAX: the raw inversion, MLE on the raw counts (the pipeline's
        # readout mitigation), the MLE-projected target, two distillation
        # steps against it and the exact chain of the starting parameters.
        target = from_complex(data.target)
        labels = data.basis_labels
        raw = jmle.bits_to_counts(data.bits)
        rho_raw = jpauli.make_counts_inverter(N, labels)(raw)
        rho_mle = jmle.make_mle(N, labels, readout_p=0.01)(raw)
        rho_t = jmle.make_mle(N, labels)(jnp.asarray(raw, jnp.float32))
        tgt = jmeasure.batched_probs_mixed(
            CArray(rho_t.re[None], rho_t.im[None]),
            from_complex(jmeasure.rotation_unitaries(labels)))[0]
        sched = jmake_schedule("cosine", T)
        jdist = jdiff.sampler_distribution(
            jax.random.key(0), state.apply_fn, {"params": state.params}, N,
            sched, exact=jc.diffusion.exact)
        jstate, jl, ji = jtrain.finetune_chain(
            state, tgt, sched, N, steps=2, learning_rate=jc.train.chain_lr,
            exact=jc.diffusion.exact,
            key=jax.random.fold_in(k_train, 0xD157))
        ref = dict(
            raw_fidelity=float(jM.state_fidelity(target, rho_raw)),
            mle_fidelity=float(jM.state_fidelity(target, rho_mle)),
            rho_mle=to_complex(rho_mle), target=np.asarray(tgt),
            exact_chain=np.asarray(jdist, np.float64), losses=np.asarray(jl),
            info=ji, params=params_from_flax(
                jax.tree_util.tree_map(np.asarray, jstate.params)))

        tc = _cfg(tcfg)
        res = tpipe.run_experiment(tc, seed=0, data_cache=cache,
                                   params_load=ppath, device="cpu",
                                   log_fn=lambda m: None)
        tcache = str(tmp / "target.npz")
        distilled = str(tmp / "distilled.pt")
        logs = []
        dres = tpipe.run_experiment(
            _cfg(tcfg, chain_finetune_steps=2, chain_target="mle"), seed=0,
            data_cache=cache, params_load=ppath, params_save=distilled,
            target_cache=tcache, stop_after="distill", device="cpu",
            log_fn=logs.append)
        rho_port = tmle.make_mle(N, labels, readout_p=0.01)(
            torch.from_numpy(np.array(raw)))
    return dict(tmp=tmp, cache=cache, ppath=ppath, tcache=tcache,
                distilled=distilled, res=res, dres=dres, logs=logs, ref=ref,
                rho_port=rho_port.numpy(), cfg=tc)


def test_raw_fidelity_and_mle_on_raw_match_jax(ladder):
    res, ref = ladder["res"], ladder["ref"]
    assert res["raw_fidelity"] == pytest.approx(ref["raw_fidelity"],
                                                abs=PROB_ATOL)
    assert res["raw_fidelity_mitigated"] == pytest.approx(
        ref["mle_fidelity"], abs=FID_ATOL)
    np.testing.assert_allclose(ladder["rho_port"], ref["rho_mle"],
                               atol=RHO_ATOL)
    assert res["mle_iterations"] == {"samples": MLE_ITERS, "raw": MLE_ITERS}
    rho = res["rho"]
    assert rho.shape == (G, G) and abs(np.trace(rho) - 1) < 1e-4
    assert np.linalg.eigvalsh(rho).min() > -1e-5


def test_mle_projected_target_matches_jax(ladder):
    with np.load(ladder["tcache"]) as z:
        got = z["target"]
    assert got.shape == (B, G)
    np.testing.assert_allclose(got, ladder["ref"]["target"], atol=PROB_ATOL)
    assert any("distillation target: MLE Born probs" in m
               for m in ladder["logs"])


def test_two_distillation_steps_match_jax(ladder):
    ref, dres = ladder["ref"], ladder["dres"]
    assert set(dres) == {"losses", "ft_losses", "ft_info"}
    np.testing.assert_allclose(dres["ft_losses"], ref["losses"], rtol=1e-5)
    for k in ("train_ce_before", "train_ce_after"):
        assert dres["ft_info"][k] == pytest.approx(ref["info"][k], rel=1e-5)
    got = torch.load(ladder["distilled"], weights_only=True)
    assert got.keys() == ref["params"].keys()
    for k, p in got.items():
        np.testing.assert_allclose(p.numpy(), ref["params"][k],
                                   atol=PARAM_ATOL, err_msg=k)


def _assert_tv_within_shot_noise(samples: torch.Tensor,
                                 exact: np.ndarray) -> None:
    idx = (samples.long() * (1 << torch.arange(N))).sum(-1)
    hist = torch.zeros((B, G), dtype=torch.float64).scatter_add_(
        1, idx, torch.ones(idx.shape, dtype=torch.float64))
    freq = hist / samples.shape[1]
    tv = 0.5 * (freq - torch.from_numpy(exact)).abs().sum(-1)
    bound = 4 * math.sqrt(G / (2 * math.pi * samples.shape[1]))
    assert float(tv.max()) < bound


@pytest.mark.parametrize("path", ["default", "gen_tables_once"])
def test_samples_follow_the_jax_exact_chain(ladder, path):
    """The eval role's samples (``sample_all_bases``: one call of 1,000
    shots, the tables and one walk) and ``sample_all_bases_chunked``'s on
    the same parameters, each within 4 shot-noise scales (TV) of JAX's exact
    chain distribution in every basis."""
    if path == "default":
        samples = ladder["res"]["samples"]
    else:
        model = restore_params(ladder["ppath"], tbuild_model(
            ladder["cfg"].model, N, T)).eval()
        samples = tdiff.sample_all_bases_chunked(
            torch.Generator().manual_seed(5), model, N, SHOTS_INFER,
            tmake_schedule("cosine", T), exact=False, max_chains=1 << 21,
            device="cpu")
    assert tuple(samples.shape) == (B, SHOTS_INFER, N)
    _assert_tv_within_shot_noise(samples, ladder["ref"]["exact_chain"])


def test_segment_protocol_on_the_cpu(ladder, monkeypatch):
    """``scripts/run_frontier_segments.py:130-205`` through the port's
    run_experiment: a CE role, a uniform and a mining segment (accum 2,
    hard_frac 0.5, the Adam state chained, the MLE target from its cache),
    then the eval role. Each segment's chain CE falls, each file loads back
    (segment 1 starts where segment 0 ended), the mining draw is not
    uniform."""
    monkeypatch.setattr(tmle, "make_mle", _capped(tmle.make_mle))
    tmp, cache, tcache = ladder["tmp"], ladder["cache"], ladder["tcache"]
    snap = lambda name: str(tmp / f"seg_{name}")  # noqa: E731
    quiet = dict(seed=0, data_cache=cache, device="cpu",
                 log_fn=lambda m: None)
    out = tpipe.run_experiment(_cfg(tcfg), params_save=snap("ce"),
                               stop_after="distill", **quiet)
    assert out["ft_info"] is None and np.isfinite(out["losses"]).all()
    restore_params(snap("ce"), tbuild_model(ladder["cfg"].model, N, T))

    infos, prev = [], snap("ce")
    for seg, (accum, hard) in enumerate(((1, 0.0), (2, 0.5))):
        cfg = _cfg(tcfg, chain_finetune_steps=3, chain_target="mle",
                   chain_basis_batch=64, chain_key_salt=seg,
                   chain_accum=accum, chain_hard_frac=hard)
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, chain_lr=1e-2))
        out = tpipe.run_experiment(
            cfg, params_load=prev, params_save=snap(seg), target_cache=tcache,
            stop_after="distill",
            opt_load=snap(f"opt{seg - 1}") if seg else "",
            opt_save=snap(f"opt{seg}"), **quiet)
        info = out["ft_info"]
        assert info["train_ce_after"] < info["train_ce_before"]
        assert int(torch.load(snap(f"opt{seg}"), weights_only=True)["count"]) \
            == 3 * (seg + 1)
        infos.append(info)
        prev = snap(seg)
    assert infos[1]["train_ce_before"] == pytest.approx(
        infos[0]["train_ce_after"], rel=1e-6)
    assert "hard_draw_p" not in infos[0]
    p = infos[1]["hard_draw_p"]
    assert p.shape == (B,) and p.sum() == pytest.approx(1.0, rel=1e-5)
    assert p.max() > 1.01 * p.min()

    res = tpipe.run_experiment(_cfg(tcfg), params_load=prev, **quiet)
    assert tuple(res["samples"].shape) == (B, SHOTS_INFER, N)
    assert res["rho"].shape == (G, G)
    assert abs(np.trace(res["rho"]) - 1) < 1e-4
    for k in ("fidelity", "raw_fidelity", "raw_fidelity_mitigated"):
        assert math.isfinite(res[k])


# The launch plan of each rung's generation (chip_smoke.SCALING_PLAN): the
# rung's (N, bases, generated shots), T = 2 in place of 100 (the plan's
# step launches scale with T), a stub denoiser and counting stand-ins for
# the two kernels' wrappers (no card here).
RUNGS = {  # tag: (N, shots_infer, gen_tables_once, (walks, walk (C, S)),
           #       (step calls a T, step B))
    "rqc4_auto": (4, 30000, False, (2, (81, 15000)), (0, None)),
    "ghz5_auto": (5, 20000, False, (3, (243, 6667)), (0, None)),
    "rqc5_auto": (5, 20000, False, (3, (243, 6667)), (0, None)),
    "ghz6_auto": (6, 10000, False, (4, (729, 2500)), (0, None)),
    "rqc6_auto": (6, 10000, False, (4, (729, 2500)), (0, None)),
    "ghz7_mle_hot": (7, 5000, False, (0, None), (6, 2187 * 834)),
    "ghz8_mle_hot": (8, 3000, True, (10, (6561, 300)), (0, None)),
}


@pytest.mark.parametrize("tag", list(RUNGS))
def test_generation_launch_plan(tag, monkeypatch):
    n, shots, once, (walks, walk_shape), (step_calls, step_b) = RUNGS[tag]
    t_steps = 2
    calls = {"walk": [], "step": []}

    def walk(seed, tables, init, num_qubits, **kw):
        calls["walk"].append((tuple(tables.shape), tuple(init.shape)))
        return init

    def step(seed, table, rows, num_qubits, step=0, *, row_base=None):
        calls["step"].append((tuple(table.shape), rows.shape[0], step))
        return rows

    monkeypatch.setattr(ck, "fused_chain_walk", walk)
    monkeypatch.setattr(ck, "fused_chain_step", step)

    def stub(x, t, basis):  # P(bit = 1) = 1/2 everywhere
        return torch.zeros(x.shape + (2,))

    base = tcfg.get_preset("rqc")
    cfg = base.replace(
        diffusion=type(base.diffusion)(num_timesteps=t_steps,
                                       schedule="cosine", sampler="renoise",
                                       gen_tables_once=once),
        data=dataclasses.replace(base.data, num_qubits=n, shots_infer=shots))
    timings = {}
    out = tpipe._generate(cfg, stub, tmake_schedule("cosine", t_steps),
                          torch.Generator().manual_seed(0),
                          torch.device("cpu"), timings, lambda m: None)
    assert tuple(out.shape) == (3**n, shots, n)
    assert len(calls["walk"]) == walks
    assert all(c == ((t_steps, 3**n, 2**n, n), walk_shape)
               for c in calls["walk"])
    assert len(calls["step"]) == step_calls * t_steps
    assert all(c[:2] == ((3**n * 2**n, n), step_b) for c in calls["step"])
    assert [c[2] for c in calls["step"]] == list(range(t_steps)) * step_calls
    # the 'seq' walk's model forwards and step launches are timed as 'walk'
    assert timings["walk"] > 0


def test_training_data_builds_one_rotation_stack(monkeypatch):
    """``generate_training_data`` builds the ``[3^N, 2^N, 2^N]`` rotation
    stack once for the noisy and the clean probabilities, as the JAX package
    does (3.4 GB at N = 8), and its data equal a second run's."""
    from ddqst_tpu_torch.qsim import measure as tmeasure

    built = []
    real = tmeasure.rotation_unitaries
    monkeypatch.setattr(tmeasure, "rotation_unitaries",
                        lambda labels: built.append(len(labels))
                        or real(labels))
    cfg = _cfg(tcfg)

    def run():
        return tpipe.generate_training_data(
            cfg, torch.Generator().manual_seed(3), np.random.default_rng(0))

    data = run()
    assert built == [B]
    again = run()
    assert torch.equal(data.bits, again.bits)
    np.testing.assert_array_equal(data.clean_probs, again.clean_probs)
    assert tuple(data.bits.shape) == (B, 40, N)
