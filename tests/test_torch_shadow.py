"""Port parity: the shadow route (label-grid tables, the shadow samplers,
the amortised full-grid sampler, label distillation with the transformer,
and _run_shadow_experiment end to end) against ddqst_tpu on the same
weights and data (CPU; the walk's plain version stands in for the kernel).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddqst_tpu import config as jcfg
from ddqst_tpu import pipeline as jpipe
from ddqst_tpu import train as jtrain
from ddqst_tpu.config import TrainConfig
from ddqst_tpu.models import transformer as jt
from ddqst_tpu.ops import diffusion as jdiff
from ddqst_tpu.ops import mle as jmle
from ddqst_tpu.ops import schedules as jsched
from ddqst_tpu_torch import cli
from ddqst_tpu_torch import config as tcfg
from ddqst_tpu_torch import pipeline as tpipe
from ddqst_tpu_torch import train as ttrain
from ddqst_tpu_torch.models import TransformerDenoiser, params_from_flax
from ddqst_tpu_torch.ops import cuda_kernels as ck
from ddqst_tpu_torch.ops import diffusion as tdiff
from ddqst_tpu_torch.ops import pauli as tpauli
from ddqst_tpu_torch.ops import schedules as tsched

# The suite runs in several xdist workers; one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)

N, T = 3, 10
G = 2**N
LABELS = np.array([[0, 1, 2], [2, 2, 2], [1, 0, 0], [2, 1, 0], [0, 0, 1]])
TABLE_ATOL = 1e-6  # table entries against JAX
RTOL = 1e-4        # distillation losses and CEs, relative, against JAX


def _tv_bound(g, shots):
    """4 shot-noise scales of a per-basis TV at ``shots`` draws."""
    return 4 * np.sqrt(g / (2 * np.pi * shots))


def _models(seed=1, t_steps=T, n=N):
    """A small flax transformer with seeded weights and the port's copy."""
    fm = jt.TransformerDenoiser(num_qubits=n, num_timesteps=t_steps,
                                embed_dim=16, hidden_dim=32, num_blocks=1,
                                num_heads=2)
    params = fm.init(jax.random.key(seed), jnp.zeros((2, n), jnp.int8),
                     jnp.ones((2,), jnp.int32),
                     jnp.zeros((2,), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.3 * rng.normal(size=a.shape)
                              .astype(np.float32)), params)
    tm = TransformerDenoiser(n, t_steps, embed_dim=16, hidden_dim=32,
                             num_blocks=1, num_heads=2)
    tm.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return fm, params, tm.eval()


def _jfn(fm, params):
    return lambda x, t, b: fm.apply({"params": params}, x, t, b)


def _label_grid(labels):
    x_enum = ((np.arange(G)[:, None] >> np.arange(N)) & 1).astype(np.int8)
    return (np.tile(x_enum, (len(labels), 1)),
            np.repeat(labels, G, axis=0).astype(np.int32))


def _spy_walk(monkeypatch):
    """Record every table the samplers hand the walk."""
    seen = []
    real = ck.fused_chain_walk

    def spy(seed, tables, init, num_qubits, **kw):
        seen.append(tables.clone())
        return real(seed, tables, init, num_qubits, **kw)

    monkeypatch.setattr(ck, "fused_chain_walk", spy)
    return seen


# --- tables --------------------------------------------------------------

@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("row_budget", [1 << 16, 7], ids=["fits", "split"])
def test_label_tables_match_jax(row_budget, exact):
    """``_tables_for_ts(grid=...)`` over a [B·2^N, N] label grid against
    JAX's ``_shadow_table_chunk``, with the grid in one forward and split
    into 7-row forwards."""
    fm, params, tm = _models()
    grid_x, grid_lab = _label_grid(LABELS)
    ts = np.arange(T, 0, -1)
    ref = jdiff._shadow_table_chunk(
        fm.apply, {"params": params}, jnp.asarray(ts), jnp.asarray(grid_x),
        jnp.asarray(grid_lab), jsched.cosine_schedule(T), N, exact,
        row_budget)
    with torch.no_grad():
        got = tdiff._tables_for_ts(
            tm, torch.from_numpy(ts), N, tsched.cosine_schedule(T), exact,
            row_budget=row_budget,
            grid=(torch.from_numpy(grid_x), torch.from_numpy(grid_lab)))
    assert got.shape == (T, len(LABELS) * G, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TABLE_ATOL)


@pytest.mark.parametrize("t_steps,max_rows", [(T, 1 << 18), (7, 80)],
                         ids=["one_chunk", "prime_T_in_chunks"])
def test_shadow_tables_assembled_in_place_match_jax(t_steps, max_rows,
                                                    monkeypatch):
    """The tables ``sample_for_bases_tables`` walks, built ``m`` timesteps
    a chunk into one buffer (80 rows: 2 timesteps a chunk, T = 7 in 4
    chunks), equal JAX's ``_tables_for_ts`` over the same grid."""
    fm, params, tm = _models(t_steps=t_steps)
    seen = _spy_walk(monkeypatch)
    tdiff.sample_for_bases_tables(
        torch.Generator().manual_seed(0), tm, LABELS, 16,
        tsched.cosine_schedule(t_steps), exact=False,
        max_table_rows=max_rows, device="cpu")
    grid_x, grid_lab = _label_grid(LABELS)
    ref = jdiff._tables_for_ts(
        _jfn(fm, params), jnp.arange(t_steps, 0, -1), N,
        jsched.cosine_schedule(t_steps), False,
        grid=(jnp.asarray(grid_x), jnp.asarray(grid_lab)))
    assert len(seen) == 1 and seen[0].shape == (t_steps, len(LABELS), G, N)
    np.testing.assert_allclose(seen[0].numpy(),
                               np.asarray(ref).reshape(seen[0].shape),
                               atol=TABLE_ATOL)


@pytest.mark.parametrize("t_steps,max_rows", [(T, 1 << 22), (7, 500)],
                         ids=["one_chunk", "prime_T_in_chunks"])
def test_chunked_sampler_tables_equal_grid_p1_tables(t_steps, max_rows,
                                                     monkeypatch):
    """``sample_all_bases_chunked``'s tables (500 rows: 2 timesteps of the
    216-row grid a chunk) equal JAX's ``grid_p1_tables``, and its walks all
    read the one buffer."""
    fm, params, tm = _models(t_steps=t_steps)
    seen = _spy_walk(monkeypatch)
    out = tdiff.sample_all_bases_chunked(
        torch.Generator().manual_seed(0), tm, N, 30,
        tsched.cosine_schedule(t_steps), exact=True,
        max_table_rows=max_rows, max_chains=27 * 12, device="cpu")
    ref = jdiff.grid_p1_tables(_jfn(fm, params), N,
                               jsched.cosine_schedule(t_steps), exact=True)
    assert out.shape == (27, 30, N) and out.dtype == torch.int8
    assert len(seen) == 3  # 30 shots, 12 a call
    assert all(torch.equal(s, seen[0]) for s in seen)
    np.testing.assert_allclose(seen[0].numpy(),
                               np.asarray(ref).reshape(seen[0].shape),
                               atol=TABLE_ATOL)


# --- samplers ------------------------------------------------------------

@pytest.mark.parametrize("sampler", ["direct", "tables", "chunked"])
def test_samplers_follow_jax_exact_chain(sampler):
    """Per basis, the samples' TV to JAX's exact chain distribution of the
    same weights is within 4 shot-noise scales."""
    fm, params, tm = _models(seed=3)
    shots = 3000
    sched = tsched.cosine_schedule(T)
    gen = torch.Generator().manual_seed(5)
    if sampler == "chunked":
        labels = tpauli.all_basis_labels(N)
        out = tdiff.sample_all_bases_chunked(
            gen, tm, N, shots, sched, exact=False, max_chains=27 * 1000,
            device="cpu")
    else:
        labels = LABELS
        out = tdiff.sample_for_bases(
            gen, tm, labels, shots, sched, exact=False, mode=sampler,
            max_chains_per_call=4000, device="cpu")
    ref = np.asarray(jdiff.chain_distribution(
        _jfn(fm, params), N, jsched.cosine_schedule(T), False,
        basis_labels=jnp.asarray(labels, jnp.int32)))
    assert out.shape == (len(labels), shots, N) and out.dtype == torch.int8
    idx = (out.long() * (1 << torch.arange(N))).sum(-1).numpy()
    hist = np.stack([np.bincount(r, minlength=G) for r in idx]) / shots
    tv = 0.5 * np.abs(hist - ref).sum(-1)
    assert (tv < _tv_bound(G, shots)).all(), tv


def test_auto_mode_takes_tables_when_chains_outnumber_grid_rows(monkeypatch):
    _, _, tm = _models()
    seen = _spy_walk(monkeypatch)
    sched = tsched.cosine_schedule(T)
    for shots, walks in ((G - 1, 0), (G, 1)):
        out = tdiff.sample_for_bases(torch.Generator().manual_seed(0), tm,
                                     LABELS, shots, sched, device="cpu")
        assert out.shape == (len(LABELS), shots, N)
        assert len(seen) == walks
    with pytest.raises(ValueError, match="mode"):
        tdiff.sample_for_bases(torch.Generator(), tm, LABELS, 4, sched,
                               mode="grid", device="cpu")


def test_auto_mode_samples_directly_above_the_walk_kernels_n(monkeypatch):
    """Above the CUDA walk's N, 'auto' takes the direct sampler and builds
    no tables (the JAX package walks any N with XLA); a forced 'tables'
    still reaches the walk's wrapper, which raises for a tensor it does not
    take its plain version for (the device check patched: no card here)."""
    n = ck._MAX_WALK_N + 1
    sched = tsched.cosine_schedule(2)
    labels = torch.full((1, n), 2)

    def stub(x, t, b):  # P(bit = 1) = 1/2 everywhere
        return torch.zeros(x.shape + (2,))

    built = []
    real = tdiff._assembled_tables
    monkeypatch.setattr(tdiff, "_assembled_tables",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    out = tdiff.sample_for_bases(torch.Generator().manual_seed(0), stub,
                                 labels, 2**n, sched, device="cpu")
    assert out.shape == (1, 2**n, n) and not built
    assert abs(float(out.float().mean()) - 0.5) < 0.01
    monkeypatch.setattr(ck, "_on_cpu", lambda t: False)
    with pytest.raises(ValueError, match=f"N <= {ck._MAX_WALK_N}"):
        tdiff.sample_for_bases(torch.Generator(), stub, labels, 4, sched,
                               mode="tables", device="cpu")
    assert built == [1]


def test_chunked_sampler_walk_options():
    _, _, tm = _models()
    sched = tsched.cosine_schedule(T)
    for walk in ("cuda", "xla"):  # no card here; 'xla' is not a port walk
        with pytest.raises(ValueError, match="walk"):
            tdiff.sample_all_bases_chunked(torch.Generator(), tm, N, 4, sched,
                                           walk=walk, device="cpu")


def test_shadow_samplers_without_device_need_cuda(monkeypatch):
    _, _, tm = _models()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tdiff.sample_for_bases(torch.Generator(), tm, LABELS, 4,
                               tsched.cosine_schedule(T))
    with pytest.raises(RuntimeError):
        tdiff.sample_all_bases_chunked(torch.Generator(), tm, N, 4,
                                       tsched.cosine_schedule(T))


# --- distillation --------------------------------------------------------

def _counts(seed, shots, rows):
    probs = np.random.default_rng(seed).dirichlet(np.ones(G), size=rows)
    rng = np.random.default_rng([seed, shots])
    return np.stack([rng.multinomial(shots, q) for q in probs]).astype(
        np.float32)


def test_label_distillation_with_the_transformer_matches_jax():
    """``finetune_chain(basis_labels=...)`` on a real transformer, full
    batch with a held-out split: losses, CEs and the selected step."""
    fm, params, tm = _models(seed=4)
    state = jtrain.create_state(jax.random.key(0), fm, TrainConfig(), N)
    state = state.replace(params=params)
    tgt, val = _counts(1, 300, len(LABELS)), _counts(1, 80, len(LABELS))
    kw = dict(steps=6, learning_rate=3e-3, exact=False, val_counts=val,
              steps_per_call=2, val_patience=2)
    _, jl, ji = jtrain.finetune_chain(
        state, tgt, jsched.cosine_schedule(T), N,
        basis_labels=jnp.asarray(LABELS, jnp.int32), **kw)
    _, tl, ti = ttrain.finetune_chain(
        tm, tgt, tsched.cosine_schedule(T), N, basis_labels=LABELS,
        device="cpu", **kw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL)
    for k in ("train_ce_before", "train_ce_after", "best_val_ce"):
        assert ti[k] == pytest.approx(ji[k], rel=RTOL), k
    assert ti["best_step"] == ji["best_step"]
    assert [s for s, _ in ti["val_history"]] == \
        [s for s, _ in ji["val_history"]]
    assert tl[-1] < tl[0]


# --- the slice as a whole ------------------------------------------------

SHOTS = 4000


def _shadow(cfg_mod, **train):
    """The shadow_transformer preset cut to a CPU test: N=7, 8 sampled
    bases, a 1-block transformer of width 16, T=10."""
    c = cfg_mod.get_preset("shadow_transformer")
    return c.replace(
        model=dataclasses.replace(c.model, embed_dim=16, hidden_dim=32,
                                  num_blocks=1, num_heads=2),
        diffusion=dataclasses.replace(c.diffusion, num_timesteps=10),
        train=dataclasses.replace(c.train, num_epochs=1, **train),
        data=dataclasses.replace(c.data, num_qubits=7, max_bases=8,
                                 shots_train=200, shots_infer=SHOTS),
    )


@pytest.fixture(scope="module")
def shadow_run(tmp_path_factory):
    """JAX's run_experiment writes the data cache and trains the weights;
    the port runs on both (params_load, no training)."""
    tmp = tmp_path_factory.mktemp("shadow")
    cache = str(tmp / "data.npz")
    jc = _shadow(jcfg)
    jres = jpipe.run_experiment(jc, seed=0, data_cache=cache,
                                log_fn=lambda m: None)
    params = jres["state"].params
    ppath = str(tmp / "params.pt")
    torch.save(params_from_flax(jax.tree_util.tree_map(np.asarray, params)),
               ppath)
    logs = []
    tres = tpipe.run_experiment(_shadow(tcfg), seed=0, data_cache=cache,
                                params_load=ppath, device="cpu",
                                log_fn=logs.append)
    return dict(tmp=tmp, cache=cache, params=params, ppath=ppath, jres=jres,
                tres=tres, logs=logs, jc=jc)


def test_port_data_equals_jax_cache(shadow_run):
    """The port's own data step draws the same bases and clean Born
    probabilities as JAX's cache for one seed."""
    jdata = jpipe.load_data_cache(shadow_run["cache"])
    tdata = tpipe.generate_training_data(
        _shadow(tcfg), torch.Generator().manual_seed(0),
        np.random.default_rng(0))
    np.testing.assert_array_equal(tdata.basis_labels, jdata.basis_labels)
    np.testing.assert_array_equal(tdata.basis_idx, jdata.basis_idx)
    np.testing.assert_allclose(tdata.clean_probs, jdata.clean_probs,
                               atol=1e-6)


def test_deterministic_metrics_equal_jax(shadow_run):
    jres, tres = shadow_run["jres"], shadow_run["tres"]
    for k in ("meas_tv_to_target", "tv_shot_noise_floor"):
        assert tres[k] == pytest.approx(jres[k], abs=1e-6), k
    assert tres["fidelity"] is None and jres["fidelity"] is None


def test_results_keys_and_values(shadow_run):
    jres, tres = shadow_run["jres"], shadow_run["tres"]
    assert set(jres) <= set(tres)
    assert {"timings", "train_steps"} <= set(tres)
    assert {"datagen", "train", "tables", "walk", "metrics"} <= \
        set(tres["timings"])
    assert tres["train_steps"] == 0 and tres["losses"].shape == (0,)
    assert isinstance(tres["state"], TransformerDenoiser)
    assert tuple(tres["samples"].shape) == (8, SHOTS, 7)
    for k in ("mean_tv_to_target", "max_tv_to_target",
              "mean_marginal_error", "max_marginal_error",
              "classical_fidelity"):
        assert np.isfinite(tres[k]), k
    assert tres["mean_tv_to_target"] <= tres["max_tv_to_target"]
    assert 0 < tres["classical_fidelity"] <= 1.0 + 1e-6
    # z_bias is None exactly when the Z...Z basis was not sampled.
    zz = (np.asarray(jpipe.load_data_cache(shadow_run["cache"]).basis_labels)
          == 2).all(1).any()
    assert (tres["z_bias"] is None) == (not zz) == (jres["z_bias"] is None)


def test_samples_follow_jax_exact_chain(shadow_run):
    jc = shadow_run["jc"]
    labels = jpipe.load_data_cache(shadow_run["cache"]).basis_labels
    ref = np.asarray(jdiff.chain_distribution_all_bases(
        jt.TransformerDenoiser(num_qubits=7, num_timesteps=10, embed_dim=16,
                               hidden_dim=32, num_blocks=1,
                               num_heads=2).apply,
        shadow_run["params"], 7, jsched.cosine_schedule(10),
        jc.diffusion.exact, basis_labels=jnp.asarray(labels, jnp.int32)))
    idx = (shadow_run["tres"]["samples"].long()
           * (1 << torch.arange(7))).sum(-1).numpy()
    hist = np.stack([np.bincount(r, minlength=128) for r in idx]) / SHOTS
    tv = 0.5 * np.abs(hist - ref).sum(-1)
    assert (tv < _tv_bound(128, SHOTS)).all(), tv


def test_film_mlp_config_is_switched_to_the_transformer(shadow_run):
    c = _shadow(tcfg)
    cfg = c.replace(model=dataclasses.replace(c.model, arch="film_mlp"),
                    data=dataclasses.replace(c.data, shots_infer=100))
    logs = []
    res = tpipe.run_experiment(cfg, seed=0, data_cache=shadow_run["cache"],
                               params_load=shadow_run["ppath"], device="cpu",
                               log_fn=logs.append)
    assert isinstance(res["state"], TransformerDenoiser)
    assert any("WARNING" in m and "switching to arch='transformer'" in m
               for m in logs)


def test_shadow_distillation_stop_after_and_opt_chain(shadow_run):
    """Label distillation through run_experiment with the shot-level
    held-out split equals JAX's ``finetune_chain`` on the same split and
    weights; ``stop_after='distill'`` returns JAX's three keys, and the
    saved params and Adam state warm-start a further run."""
    tmp = shadow_run["tmp"]
    cfg = _shadow(tcfg, chain_finetune_steps=4, chain_lr=3e-3,
                  chain_val_fraction=0.2, chain_steps_per_call=2)
    logs = []
    out = tpipe.run_experiment(
        cfg, seed=0, data_cache=shadow_run["cache"],
        params_load=shadow_run["ppath"], params_save=str(tmp / "d.pt"),
        opt_save=str(tmp / "opt.pt"), stop_after="distill", device="cpu",
        log_fn=logs.append)
    assert set(out) == {"losses", "ft_losses", "ft_info"}
    data = jpipe.load_data_cache(shadow_run["cache"])
    s_val = 40  # round(0.2 · 200)
    jc = _shadow(jcfg)
    state = jtrain.create_state(
        jax.random.key(0),
        jt.TransformerDenoiser(num_qubits=7, num_timesteps=10, embed_dim=16,
                               hidden_dim=32, num_blocks=1, num_heads=2),
        jc.train, 7).replace(params=shadow_run["params"])
    _, jl, ji = jtrain.finetune_chain(
        state, jmle.bits_to_counts(data.bits[:, :-s_val]),
        jsched.cosine_schedule(10), 7, steps=4, learning_rate=3e-3,
        exact=jc.diffusion.exact, steps_per_call=2,
        val_counts=jmle.bits_to_counts(data.bits[:, -s_val:]),
        val_patience=jc.train.chain_val_patience,
        basis_labels=jnp.asarray(data.basis_labels, jnp.int32))
    np.testing.assert_allclose(out["ft_losses"], np.asarray(jl), rtol=RTOL)
    info = out["ft_info"]
    for k in ("train_ce_before", "train_ce_after", "best_val_ce"):
        assert info[k] == pytest.approx(ji[k], rel=RTOL), k
    assert info["best_step"] == ji["best_step"]
    assert any("chain CE (all shadow bases)" in m for m in logs)
    assert not any("sampling" in m for m in logs)

    opt = torch.load(str(tmp / "opt.pt"), weights_only=True)
    assert int(opt["count"]) == 4
    cfg2 = _shadow(tcfg, chain_finetune_steps=1)
    res = tpipe.run_experiment(
        cfg2.replace(data=dataclasses.replace(cfg2.data, shots_infer=100)),
        seed=0, data_cache=shadow_run["cache"], params_load=str(tmp / "d.pt"),
        opt_load=str(tmp / "opt.pt"), device="cpu", log_fn=lambda m: None)
    assert res["ft_losses"].shape == (1,)
    assert np.isfinite(res["chain_info"]["train_ce_after"])


def test_shadow_route_through_the_cli_on_the_cpu(capsys):
    assert cli.main([
        "run", "--preset", "shadow_transformer", "--num_qubits", "7",
        "--max_bases", "8", "--embed_dim", "16", "--hidden_dim", "32",
        "--num_blocks", "1", "--epochs", "1", "--timesteps", "10",
        "--shots_train", "200", "--shots_infer", "300", "--device", "cpu",
    ]) == 0
    out = capsys.readouterr().out
    assert "shadow-scale training on 1600 shots (8 bases)" in out
    assert "shadow-scale vs exact Born probs" in out
