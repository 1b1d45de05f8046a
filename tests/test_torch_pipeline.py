"""The slice as a whole: the port's run_experiment on the JAX package's own
data cache and weights, against the JAX package's estimators."""

import dataclasses
import os
import subprocess
import sys

import jax
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
from ddqst_tpu.ops.complexlib import from_complex
from ddqst_tpu.ops.schedules import make_schedule as jmake_schedule
from ddqst_tpu_torch import config as tcfg
from ddqst_tpu_torch import pipeline as tpipe
from ddqst_tpu_torch.models import params_from_flax

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
    flax, optax or ddqst_tpu."""
    code = (
        "import pkgutil, importlib, sys, ddqst_tpu_torch\n"
        "for m in pkgutil.walk_packages(ddqst_tpu_torch.__path__, "
        "'ddqst_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ddqst_tpu')]\n"
        "assert not bad, bad\n"
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


@pytest.mark.parametrize("section,change", [
    ("train", dict(chain_finetune_steps=10)),
    ("diffusion", dict(infer_mode="denoise")),
    ("diffusion", dict(gen_tables_once=True)),
    ("data", dict(reconstruction="mle")),
    ("data", dict(max_bases=5)),
    ("data", dict(num_qubits=9)),
    ("train", dict(checkpoint_dir="ckpt")),
    ("model", dict(arch="transformer")),
    (None, None),  # a mesh
])
def test_unported_options_raise(section, change):
    cfg = _small(tcfg)
    mesh = None
    if section is None:
        mesh = object()
    else:
        cfg = cfg.replace(**{section: dataclasses.replace(getattr(cfg, section),
                                                          **change)})
    with pytest.raises(NotImplementedError):
        tpipe.run_experiment(cfg, seed=0, mesh=mesh, device="cpu",
                             log_fn=lambda m: None)
