"""The slice as a whole: the port's run_experiment on the JAX package's own
data cache and weights, against the JAX package's estimators."""

import dataclasses
import os
import subprocess
import sys

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
from ddqst_tpu.ops.complexlib import CArray, from_complex
from ddqst_tpu.ops.schedules import make_schedule as jmake_schedule
from ddqst_tpu.qsim import measure as jmeasure
from ddqst_tpu.qsim import noise as jnoise
from ddqst_tpu_torch import config as tcfg
from ddqst_tpu_torch import pipeline as tpipe
from ddqst_tpu_torch.models import params_from_flax
from ddqst_tpu_torch.ops import diffusion as tdiff
from ddqst_tpu_torch.ops.schedules import make_schedule as tmake_schedule
from ddqst_tpu_torch.parallel import make_mesh

# The suite runs in several xdist workers; one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)

REPO =os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHOTS = 5000


def _small(cfg_mod):
    """The rqc preset cut to a CPU test: hidden 32, 2 blocks, T=20."""
    c = cfg_mod.get_preset("rqc")
    return c.replace(
        model=dataclasses.replace(c.model, embed_dim=16, hidden_dim=32,
                                  num_blocks=2),
        diffusion=dataclasses.replace(c.diffusion, num_timesteps=20),
        train=dataclasses.replace(c.train, num_epochs=2),
        data=dataclasses.replace(c.data, shots_infer=SHOTS),
    )


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    cfg = _small(jcfg)
    n = cfg.data.num_qubits
    k_data, k_train, _ = jax.random.split(jax.random.key(0), 3)
    data = jpipe.generate_training_data(cfg, k_data, np.random.default_rng(0))
    cache = str(tmp / "data.npz")
    jpipe.save_data_cache(cache, data)

    sched = jmake_schedule("cosine", cfg.diffusion.num_timesteps)
    state = jtrain.create_state(k_train, jbuild_model(cfg.model, n, 20),
                                cfg.train, n)
    x, basis = jpipe.flatten_for_training(data.bits, data.basis_idx)
    for e in range(2):
        state, _ = jtrain._run_epoch(state, jax.random.fold_in(k_train, e), x,
                                     basis, sched, cfg.train.batch_size)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    ppath = str(tmp / "params.pt")
    torch.save(params_from_flax(params), ppath)

    # JAX reference: the exact chain distribution, inverted at SHOTS/basis.
    dist = jdiff.sampler_distribution(jax.random.key(0), state.apply_fn,
                                      {"params": state.params}, n, sched)
    target = from_complex(data.target)
    rho_exact = jpauli.make_counts_inverter(n)(dist * SHOTS)
    raw_counts = jmle.bits_to_counts(data.bits)
    rho_raw = jpauli.make_counts_inverter(n, data.basis_labels)(raw_counts)
    ref = {
        "fidelity_exact_chain": float(jM.state_fidelity(target, rho_exact)),
        "raw_fidelity": float(jM.state_fidelity(target, rho_raw)),
    }
    logs = []
    res = tpipe.run_experiment(
        _small(tcfg), seed=0, data_cache=cache, params_load=ppath,
        params_save=str(tmp / "resaved.pt"), device="cpu",
        log_fn=logs.append)
    return dict(res=res, ref=ref, logs=logs, tmp=tmp, params=ppath)


def test_raw_fidelity_equals_jax_inversion_of_the_cache(slice_run):
    assert slice_run["res"]["raw_fidelity"] == pytest.approx(
        slice_run["ref"]["raw_fidelity"], abs=1e-5)


def test_generated_fidelity_near_jax_exact_chain(slice_run):
    res, ref = slice_run["res"], slice_run["ref"]
    assert abs(res["fidelity"] - ref["fidelity_exact_chain"]) < 0.02


def test_results_dict_and_state_validity(slice_run):
    res = slice_run["res"]
    for k in ("fidelity", "raw_fidelity", "raw_fidelity_mitigated",
              "trace_distance", "trace_distance_raw", "expectations",
              "expectations_raw", "purity", "vn_entropy", "ent_entropy",
              "z_bias", "losses", "rho", "rho_raw", "target", "state",
              "samples"):
        assert k in res, k
    rho = res["rho"]
    assert rho.shape == (8, 8) and rho.dtype == np.complex64
    assert abs(np.trace(rho) - 1) < 1e-4
    np.testing.assert_allclose(rho, rho.conj().T, atol=1e-5)
    assert np.linalg.eigvalsh(rho).min() > -1e-5
    assert tuple(res["samples"].shape) == (27, SHOTS, 3)
    assert res["losses"].shape == (0,)  # warm start: CE training skipped
    assert set(res["timings"]) == {"datagen", "train", "tables", "walk",
                                   "inversion", "metrics"}
    assert any("loading cached data" in m for m in slice_run["logs"])


def test_params_save_roundtrip(slice_run):
    a = torch.load(slice_run["params"], weights_only=True)
    b = torch.load(str(slice_run["tmp"] / "resaved.pt"), weights_only=True)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_port_data_cache_reads_in_jax(tmp_path):
    cfg = _small(tcfg)
    gen = torch.Generator().manual_seed(0)
    data = tpipe.generate_training_data(cfg, gen, np.random.default_rng(0))
    path = str(tmp_path / "port.npz")
    tpipe.save_data_cache(path, data)
    back = jpipe.load_data_cache(path)
    np.testing.assert_array_equal(np.asarray(back.bits), data.bits.numpy())
    np.testing.assert_array_equal(back.basis_labels, data.basis_labels)
    np.testing.assert_array_equal(back.target, data.target)
    np.testing.assert_allclose(back.clean_probs, data.clean_probs)
    # Same seed -> the same circuit, so the same target as the JAX package.
    jdata = jpipe.generate_training_data(_small(jcfg), jax.random.key(0),
                                         np.random.default_rng(0))
    np.testing.assert_array_equal(data.target, jdata.target)


def test_ensure_data_cache_writes_what_run_experiment_generates(tmp_path):
    """The cache equals the data run_experiment generates for the seed (its
    own cache, bits equal on the CPU); the circuit, bases and target equal
    the JAX package's ensure_data_cache at the same seed; an existing file
    is left alone."""
    cfg = _small(tcfg)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, num_epochs=1),
                      data=dataclasses.replace(cfg.data, shots_train=64,
                                               max_bases=20))
    path = str(tmp_path / "ensured.npz")
    logs = []
    assert tpipe.ensure_data_cache(cfg, 3, path, log_fn=logs.append,
                                   device="cpu") == path
    assert any("datagen" in m for m in logs)
    mtime = os.path.getmtime(path)
    assert tpipe.ensure_data_cache(cfg, 3, path, device="cpu") == path
    assert os.path.getmtime(path) == mtime
    run_cache = str(tmp_path / "run.npz")
    tpipe.run_experiment(cfg, seed=3, data_cache=run_cache, stop_after="distill",
                         device="cpu", log_fn=lambda m: None)
    a, b = tpipe.load_data_cache(path), tpipe.load_data_cache(run_cache)
    assert torch.equal(a.bits, b.bits)
    np.testing.assert_array_equal(a.basis_idx, b.basis_idx)
    jpath = str(tmp_path / "jax.npz")
    jcfg_small = _small(jcfg)
    jcfg_small = jcfg_small.replace(data=dataclasses.replace(
        jcfg_small.data, shots_train=64, max_bases=20))
    jpipe.ensure_data_cache(jcfg_small, 3, jpath, log_fn=lambda m: None)
    j = jpipe.load_data_cache(jpath)
    np.testing.assert_array_equal(a.basis_labels, j.basis_labels)
    np.testing.assert_array_equal(a.basis_idx, j.basis_idx)
    np.testing.assert_array_equal(a.target, j.target)
    assert a.bits.shape == tuple(j.bits.shape)


def test_mitigate_train_data_path_runs(tmp_path):
    c = _small(tcfg)
    cfg = c.replace(data=dataclasses.replace(c.data, mitigate_train_data=True,
                                             mitigate_readout=True,
                                             shots_infer=300),
                    train=dataclasses.replace(c.train, num_epochs=1))
    res = tpipe.run_experiment(cfg, seed=1, device="cpu", log_fn=lambda m: None)
    assert np.isfinite(res["fidelity"]) and res["raw_fidelity_mitigated"] > 0
    assert res["train_steps"] == 27
    assert res["losses"].shape == (1,)


def test_port_imports_no_jax():
    """Every ddqst_tpu_torch module, and chip_smoke.py, import without jax,
    flax, optax, ddqst_tpu or any module of scripts/, and the C++ engine
    builds and runs without them."""
    code = (
        "import os, pkgutil, importlib, sys, ddqst_tpu_torch\n"
        "for m in pkgutil.walk_packages(ddqst_tpu_torch.__path__, "
        "'ddqst_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for name in ('ops.mle', 'ops.pauli', 'ops.diffusion', 'train', "
        "'pipeline', 'evaluate', 'cli', 'utils.checkpoint', "
        "'utils.profiling', 'models.transformer', 'models.d3pm', "
        "'parallel.mesh', 'parallel.tensor', 'qsim.native_engine', "
        "'bench', 'campaigns.recipes', 'campaigns.scaling', "
        "'campaigns.shadow_scale', 'campaigns.segments', "
        "'campaigns.shadow_segments', 'campaigns.parity_suite', "
        "'campaigns.rqc3_ceiling', 'campaigns.mle_target', "
        "'campaigns.exact_rescore', 'campaigns.average_params', "
        "'campaigns.eval_chain_ce_subset', 'campaigns.ghz8_sector_profile', "
        "'campaigns.shadow_sector_profile', 'campaigns.ghz8_eval_floor', "
        "'campaigns.diag', 'campaigns.diag_segment_descent', "
        "'campaigns.diag_floor_escape', 'campaigns.diag_hard_mining'):\n"
        "    assert 'ddqst_tpu_torch.' + name in sys.modules, name\n"
        "from ddqst_tpu_torch.qsim import native_engine, states\n"
        "psi = native_engine.statevectors([states.prep_circuit('bell', 2)])\n"
        "assert psi.shape == (1, 4), psi.shape\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ddqst_tpu')]\n"
        "assert not bad, bad\n"
        "scripts = os.path.abspath('scripts')\n"
        "from_scripts = [m for m, mod in list(sys.modules.items()) if "
        "os.path.dirname(os.path.abspath(getattr(mod, '__file__', None) "
        "or '/')) == scripts]\n"
        "assert not from_scripts, from_scripts\n"
        "print('ok', len([m for m in sys.modules if m.startswith('ddqst_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_run_experiment_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tpipe.run_experiment(_small(tcfg), seed=0, log_fn=lambda m: None)


# Options that raised NotImplementedError until they were ported (the mesh,
# the (None, None) case, last); their cases stay in the list below and now
# assert what the option does.
@pytest.mark.parametrize("section,change", [
    ("train", dict(chain_finetune_steps=10)),
    ("diffusion", dict(infer_mode="denoise")),
    ("diffusion", dict(gen_tables_once=True)),
    ("data", dict(reconstruction="mle")),
    ("data", dict(max_bases=5)),
    ("data", dict(num_qubits=9, max_bases=3)),  # the shadow route
    ("train", dict(checkpoint_dir="ckpt")),
    ("model", dict(arch="transformer")),
    (None, None),  # a mesh
])
def test_unported_options_raise(section, change, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the checkpoint case writes ./ckpt
    cfg = _small(tcfg)
    if section is None:
        # A one-rank mesh (a one-process gloo world) runs as no mesh does.
        cfg = cfg.replace(
            train=dataclasses.replace(cfg.train, num_epochs=1),
            data=dataclasses.replace(cfg.data, shots_train=200,
                                     shots_infer=400))
        mesh = make_mesh(data=1, device="cpu")
        try:
            on_mesh = tpipe.run_experiment(cfg, seed=0, mesh=mesh,
                                           device="cpu", log_fn=lambda m: None)
        finally:
            torch.distributed.destroy_process_group()
        plain = tpipe.run_experiment(cfg, seed=0, device="cpu",
                                     log_fn=lambda m: None)
        assert mesh.shape == {"data": 1, "model": 1} and mesh.backend == "gloo"
        assert np.array_equal(on_mesh["losses"], plain["losses"])
        assert np.array_equal(on_mesh["rho"], plain["rho"])
        assert on_mesh["fidelity"] == plain["fidelity"]
        return
    cfg = cfg.replace(**{section: dataclasses.replace(getattr(cfg, section),
                                                      **change)})
    cfg = cfg.replace(
        train=dataclasses.replace(cfg.train, num_epochs=1),
        data=dataclasses.replace(cfg.data, shots_train=200, shots_infer=400))
    logs = []
    res = tpipe.run_experiment(cfg, seed=0, device="cpu", log_fn=logs.append)
    if "num_qubits" in change:
        # N = 9 takes the shadow route: the film_mlp config becomes a
        # transformer, 3 sampled bases, no density matrix.
        assert res["fidelity"] is None and "rho" not in res
        assert tuple(res["samples"].shape) == (3, 400, 9)
        assert 0 <= res["mean_tv_to_target"] <= 1
        assert any("switching to arch='transformer'" in m for m in logs)
        return
    rho = res["rho"]
    assert abs(np.trace(rho) - 1) < 1e-4
    assert np.linalg.eigvalsh(rho).min() > -1e-5
    if "chain_finetune_steps" in change:
        info = res["chain_info"]
        assert res["ft_losses"].shape == (10,)
        assert info["train_ce_after"] < info["train_ce_before"]
        assert {"target", "distill"} <= set(res["timings"])
    else:
        assert "chain_info" not in res and "distill" not in res["timings"]
    if "reconstruction" in change:
        assert set(res["mle_iterations"]) == {"samples", "raw"}
        assert 0 < res["raw_fidelity_mitigated"] <= 1.001
    else:
        assert res["mle_iterations"] == {}
    if "gen_tables_once" in change or "arch" in change:
        assert tuple(res["samples"].shape) == (27, 400, 3)
        assert {"tables", "walk"} <= set(res["timings"])
        assert 0 < res["fidelity"] <= 1.001
    if "infer_mode" in change:
        # The 200 measured shots a basis, tiled twice and denoised.
        assert tuple(res["samples"].shape) == (27, 400, 3)
        assert "denoise" in res["timings"] and "walk" not in res["timings"]
        assert 0 < res["fidelity"] <= 1.001
    if "checkpoint_dir" in change:
        assert os.listdir(tmp_path / "ckpt") == ["1"]
    if "max_bases" in change:
        # Five measured bases: the dense inverter reconstructs the raw shots,
        # the generated ones still cover the whole grid.
        assert tuple(res["samples"].shape) == (27, 400, 3)
        assert 0 < res["raw_fidelity"] <= 1.001


# --- the bench recipe at a small size: distillation, MLE, caches ----------

def _recipe(cfg_mod, **train):
    """The bench recipe on the small model: renoise sampler, readout noise,
    both mitigations, MLE reconstruction, distillation with a held-out
    split."""
    c = _small(cfg_mod)
    return c.replace(
        diffusion=dataclasses.replace(c.diffusion, sampler="renoise"),
        train=dataclasses.replace(
            c.train, chain_finetune_steps=6, chain_lr=1e-3,
            chain_val_fraction=0.15, chain_steps_per_call=2, **train),
        data=dataclasses.replace(
            c.data, noise_type="readout", shots_train=400, shots_infer=3000,
            mitigate_readout=True, mitigate_train_data=True,
            reconstruction="mle"),
    )


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    """JAX writes the data cache and trains the weights; the port distils
    them (``stop_after='distill'``), and JAX distils them too."""
    tmp = tmp_path_factory.mktemp("recipe")
    jc = _recipe(jcfg)
    n = jc.data.num_qubits
    k_data, k_train, _ = jax.random.split(jax.random.key(3), 3)
    data = jpipe.generate_training_data(jc, k_data, np.random.default_rng(3))
    cache = str(tmp / "data.npz")
    jpipe.save_data_cache(cache, data)
    sched = jmake_schedule("cosine", jc.diffusion.num_timesteps)
    state = jtrain.create_state(k_train, jbuild_model(jc.model, n, 20),
                                jc.train, n)
    x, basis = jpipe.flatten_for_training(data.bits, data.basis_idx)
    for e in range(2):
        state, _ = jtrain._run_epoch(state, jax.random.fold_in(k_train, e), x,
                                     basis, sched, jc.train.batch_size)
    ppath = str(tmp / "params.pt")
    torch.save(params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                       state.params)), ppath)
    # The split of pipeline.run_experiment: the last round(0.15·S) shots.
    s_val = 60
    tgt = jmle.bits_to_counts(data.bits[:, :-s_val])
    val = jmle.bits_to_counts(data.bits[:, -s_val:])
    logs = []
    out = tpipe.run_experiment(
        _recipe(tcfg), seed=3, data_cache=cache, params_load=ppath,
        params_save=str(tmp / "distilled.pt"), opt_save=str(tmp / "opt.pt"),
        stop_after="distill", device="cpu", log_fn=logs.append)
    return dict(tmp=tmp, cache=cache, params=ppath, data=data, state=state,
                sched=sched, tgt=tgt, val=val, out=out, logs=logs, n=n)


def _jax_distill(recipe, target):
    jc = _recipe(jcfg)
    return jtrain.finetune_chain(
        recipe["state"], target, recipe["sched"], recipe["n"], steps=6,
        learning_rate=1e-3, exact=jc.diffusion.exact, steps_per_call=2,
        val_counts=recipe["val"], val_patience=jc.train.chain_val_patience)


def _assert_distillation_matches(ft_losses, info, jl, ji):
    """Full-batch distillation draws nothing: 1e-4 relative."""
    np.testing.assert_allclose(ft_losses, np.asarray(jl), rtol=1e-4)
    for k in ("train_ce_before", "train_ce_after", "best_val_ce"):
        assert info[k] == pytest.approx(ji[k], rel=1e-4), k
    assert info["best_step"] == ji["best_step"]
    assert [s for s, _ in info["val_history"]] == \
        [s for s, _ in ji["val_history"]]


def test_stop_after_distill_matches_jax_distillation(recipe):
    out = recipe["out"]
    assert set(out) == {"losses", "ft_losses", "ft_info"}  # JAX's keys
    assert out["losses"].shape == (0,)
    assert "final_opt_state" not in out["ft_info"]
    _, jl, ji = _jax_distill(recipe, recipe["tgt"])
    _assert_distillation_matches(out["ft_losses"], out["ft_info"], jl, ji)
    assert any("chain CE (full grid)" in m and "held-out best" in m
               for m in recipe["logs"])
    assert not any("sampling" in m for m in recipe["logs"])


def test_opt_save_holds_the_final_adam_state(recipe):
    opt = torch.load(str(recipe["tmp"] / "opt.pt"), weights_only=True)
    assert int(opt["count"]) == len(recipe["out"]["ft_losses"])
    distilled = torch.load(str(recipe["tmp"] / "distilled.pt"),
                           weights_only=True)
    assert opt["mu"].keys() == opt["nu"].keys() == distilled.keys()
    assert any(float(v.abs().max()) > 0 for v in opt["nu"].values())
    before = torch.load(recipe["params"], weights_only=True)
    assert any(not torch.equal(distilled[k], before[k]) for k in before)


def test_params_load_of_the_distilled_model_runs_the_mle_tail(recipe):
    """The second half of a segmented run: chain_finetune_steps=0, the
    distilled params, MLE on the samples and on the raw shots."""
    c = _recipe(tcfg)
    cfg = c.replace(train=dataclasses.replace(c.train, chain_finetune_steps=0))
    res = tpipe.run_experiment(
        cfg, seed=3, data_cache=recipe["cache"],
        params_load=str(recipe["tmp"] / "distilled.pt"), device="cpu",
        log_fn=lambda m: None)
    assert "chain_info" not in res
    assert set(res["mle_iterations"]) == {"samples", "raw"}
    assert set(res["timings"]) == {"datagen", "train", "tables", "walk",
                                   "inversion", "metrics"}
    data, n = recipe["data"], recipe["n"]
    target = from_complex(data.target)
    raw = jmle.bits_to_counts(data.bits)
    p = jnoise.get_noise_config("readout").readout_p
    ref = jmle.make_mle(n, data.basis_labels, readout_p=p)(raw)
    # 1e-4: the MLE fidelity tolerance against JAX's solve.
    assert res["raw_fidelity_mitigated"] == pytest.approx(
        float(jM.state_fidelity(target, ref)), abs=1e-4)
    lin = jpauli.make_counts_inverter(n, data.basis_labels)(raw)
    assert res["raw_fidelity"] == pytest.approx(
        float(jM.state_fidelity(target, lin)), abs=1e-5)
    # The samples follow the distilled chain: within 0.02 (3000 shots a
    # basis) of the MLE of the exact chain distribution of the same weights.
    exact = tdiff.sampler_distribution(
        res["state"], n, tmake_schedule("cosine", 20), exact=False).numpy()
    fid = float(jM.state_fidelity(
        target, jmle.make_mle(n)(jnp.asarray(exact * 3000))))
    assert abs(res["fidelity"] - fid) < 0.02


def test_chain_target_mle_with_target_cache_and_opt_load(recipe):
    """chain_target='mle': the target is the Born distribution of the
    counts' MLE (JAX's, within the MLE tolerance), written to target_cache
    and read back by the next run; opt_load chains the Adam state."""
    tmp, n, data = recipe["tmp"], recipe["n"], recipe["data"]
    tcache = str(tmp / "target.npz")
    cfg = _recipe(tcfg, chain_target="mle")
    kw = dict(seed=3, data_cache=recipe["cache"], params_load=recipe["params"],
              target_cache=tcache, device="cpu")
    logs = []
    res = tpipe.run_experiment(cfg, log_fn=logs.append, **kw)
    assert any(m.endswith("distillation target: MLE Born probs")
               for m in logs)
    rho_t = jmle.make_mle(n, data.basis_labels)(recipe["tgt"])
    rots = from_complex(jmeasure.rotation_unitaries(data.basis_labels))
    want = np.asarray(jmeasure.batched_probs_mixed(
        CArray(rho_t.re[None], rho_t.im[None]), rots)[0])
    with np.load(tcache) as z:
        got = z["target"]
    assert got.shape == (27, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-4)  # ρ's MLE tolerance
    assert res["mle_iterations"].keys() == {"target", "samples", "raw"}
    assert {"target", "distill"} <= set(res["timings"])
    for k in ("fidelity", "raw_fidelity", "raw_fidelity_mitigated",
              "chain_info", "ft_losses", "state", "samples", "rho"):
        assert k in res, k
    # JAX distilled against the port's target takes the same steps.
    _, jl, ji = _jax_distill(recipe, jnp.asarray(got))
    _assert_distillation_matches(res["ft_losses"], res["chain_info"], jl, ji)

    logs2 = []
    res2 = tpipe.run_experiment(cfg, log_fn=logs2.append,
                                opt_load=str(tmp / "opt.pt"), **kw)
    assert any("cached" in m and tcache in m for m in logs2)
    assert any("chained distillation Adam state" in m for m in logs2)
    assert "target" not in res2["mle_iterations"]
    assert res2["chain_info"]["train_ce_before"] == pytest.approx(
        res["chain_info"]["train_ce_before"], rel=1e-6)
    # Warm moments: the first step already differs from the cold run's second.
    assert res2["ft_losses"][1] != res["ft_losses"][1]


def test_distillation_is_skipped_with_a_warning_on_a_basis_subset():
    c = _recipe(tcfg)
    cfg = c.replace(
        train=dataclasses.replace(c.train, num_epochs=1),
        data=dataclasses.replace(c.data, max_bases=7, shots_infer=300))
    logs = []
    res = tpipe.run_experiment(cfg, seed=0, device="cpu", log_fn=logs.append)
    assert any("WARNING: chain distillation skipped" in m for m in logs)
    assert "chain_info" not in res and "distill" not in res["timings"]
    assert np.isfinite(res["fidelity"])
    assert set(res["mle_iterations"]) == {"samples", "raw"}


def test_chain_key_salt_changes_only_the_minibatch_stream():
    """Same seed, another salt: other minibatches, the same data."""
    def run(salt):
        c = _recipe(tcfg, chain_basis_batch=9, chain_key_salt=salt)
        cfg = c.replace(
            train=dataclasses.replace(c.train, num_epochs=1,
                                      chain_val_fraction=0.0),
            data=dataclasses.replace(c.data, shots_train=100))
        out = tpipe.run_experiment(cfg, seed=5, stop_after="distill",
                                   device="cpu", log_fn=lambda m: None)
        return out["losses"], out["ft_losses"]

    (l0, f0), (l0b, f0b), (l1, f1) = run(0), run(0), run(1)
    np.testing.assert_array_equal(f0, f0b)
    np.testing.assert_array_equal(l0, l1)
    assert not np.array_equal(f0, f1)
