"""The port's drivers of ``scripts/run_parity_suite.py``,
``run_rqc3_ceiling.py`` and ``exact_rescore.py`` against those scripts, on
the CPU (``run_shadow_segments.py``'s counterpart is held in
``tests/test_torch_shadow_segments.py``, ``make_mle_target.py``'s in
``tests/test_torch_campaigns.py``, beside the segments driver that calls
it).

- ``parity_suite``: the tags, reference values, notes and configs equal the
  script's; each phase-3 target state at seed 0 equals the JAX package's;
  a cut row has the script's keys and ``device``, and a rerun adds none;
- ``rqc3_ceiling``: the exact-distribution rows equal the script's and the
  committed record's within ``MLE_TOL``, a sampled row the script's within
  ``FIDELITY_SDS``·√2 shot-noise standard deviations; the ``--run``
  configs equal the script's;
- ``exact_rescore``: one set of weights through the script and the port:
  the exact fidelity within ``MLE_TOL``, the sampled one within shot noise.
"""

import dataclasses
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from ddqst_tpu import pipeline as jpipe
from ddqst_tpu import train as jtrain
from ddqst_tpu.models import build_model as jbuild_model
from ddqst_tpu.utils import checkpoint as jckpt
from ddqst_tpu_torch import pipeline as tpipe
from ddqst_tpu_torch.campaigns import (exact_rescore, parity_suite,
                                       read_rows, rqc3_ceiling)
from ddqst_tpu_torch.models import params_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
sys.path.insert(0, SCRIPTS)

import run_parity_suite  # noqa: E402
import run_rqc3_ceiling  # noqa: E402
import run_scaling_ghz  # noqa: E402

torch.set_num_threads(1)

MLE_TOL = 1e-4
FIDELITY_SDS = 4.0


def _jax_env():
    env = dict(os.environ)
    env.update(DDQST_CPU="1", JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    return env


# ---------------------------------------------------------------- parity

def test_parity_experiments_match_the_script():
    got = list(parity_suite.experiments())
    want = list(run_parity_suite.experiments())
    assert len(got) == len(want) == 14
    assert [(t, r, n) for t, _, r, n in got] == [(t, r, n)
                                                 for t, _, r, n in want]
    for (tag, c, _, _), (_, w, _, _) in zip(got, want):
        assert dataclasses.asdict(c) == dataclasses.asdict(w), tag


@pytest.mark.parametrize("noise", parity_suite.PHASE3_NOISES)
def test_phase3_target_matches_jax(noise):
    tag = f"phase3_rqc2_{noise}"
    (c,) = [c for t, c, _, _ in parity_suite.experiments() if t == tag]
    (w,) = [c for t, c, _, _ in run_parity_suite.experiments() if t == tag]
    k_data, _, _ = jax.random.split(jax.random.key(0), 3)
    want = jpipe.generate_training_data(w, k_data, np.random.default_rng(0))
    got = tpipe.generate_training_data(c, torch.Generator().manual_seed(0),
                                       np.random.default_rng(0))
    np.testing.assert_allclose(np.asarray(got.target),
                               np.asarray(want.target), atol=1e-6, rtol=0)


def test_cut_parity_row_and_rerun(tmp_path):
    out = str(tmp_path / "parity.jsonl")
    ((row, res),) = parity_suite.run(out, only="phase3_rqc2_readout",
                                     device="cpu", epochs=1)
    assert res is not None and read_rows(out) == [row]
    want = read_rows(os.path.join(ROOT, "examples", "results_parity.jsonl"))
    assert set(row) == set(want[0]) | {"device"} and row["device"] == "cpu"
    assert row["tag"] == "phase3_rqc2_readout" and row["reference"] is None
    assert 0.0 <= row["fidelity"] <= 1.0
    ((again, res2),) = parity_suite.run(out, only="phase3_rqc2_readout",
                                        device="cpu", epochs=1)
    assert res2 is None and again == row and len(read_rows(out)) == 1
    assert "| phase3_rqc2_readout |" in parity_suite.table([row])


# ----------------------------------------------------------- rqc3 ceiling

@pytest.fixture(scope="module")
def ceiling(tmp_path_factory):
    """The script's ``--ceiling`` (a JAX process) beside the port's."""
    tmp = tmp_path_factory.mktemp("ceiling")
    jout = str(tmp / "jax.jsonl")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(SCRIPTS, "run_rqc3_ceiling.py"),
         "--ceiling", "--out", jout], env=_jax_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    got = rqc3_ceiling.run_ceiling(str(tmp / "port.jsonl"),
                                   torch.device("cpu"))
    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log
    return got, read_rows(jout)


def test_exact_rows_match_the_script_and_the_record(ceiling):
    got, want = ceiling
    record = read_rows(os.path.join(ROOT, "examples", "rqc3_ceiling.jsonl"))
    assert len(got) == len(want) == len(record) == 12
    for g, w, rec in zip(got, want, record):
        assert {k: g[k] for k in ("mode", "seed")} == {
            k: w[k] for k in ("mode", "seed")} and g["device"] == "cpu"
        assert set(g) == set(w) | {"device"}
        if g["mode"] != "exact_distribution":
            continue
        for k in ("mle_noise_aware", "mle_plain", "linear_mitigated"):
            assert abs(g[k] - w[k]) <= MLE_TOL, (k, g, w)
            assert abs(g[k] - rec[k]) <= MLE_TOL, (k, g, rec)


def test_sampled_row_within_shot_noise_of_the_script(ceiling):
    got, want = ceiling
    (g,) = [r for r in got if r["mode"] == "sampled" and r["seed"] == 1
            and r["shots"] == 5000]
    (w,) = [r for r in want if r["mode"] == "sampled" and r["seed"] == 1
            and r["shots"] == 5000]
    target, probs, _ = rqc3_ceiling.noisy_setup(1, torch.device("cpu"))
    sd = chip_smoke.fidelity_shot_sd(3, torch.from_numpy(target),
                                     torch.from_numpy(probs), 5000)
    assert sd > 0
    assert (abs(g["mle_noise_aware"] - w["mle_noise_aware"])
            <= FIDELITY_SDS * math.sqrt(2) * sd), (g, w, sd)


def test_run_configs_match_the_script():
    got = list(rqc3_ceiling.experiments())
    want = list(run_rqc3_ceiling.experiments())
    assert [(t, n) for t, _, n in got] == [(t, n) for t, _, n in want]
    for (tag, c, _), (_, w, _) in zip(got, want):
        assert dataclasses.asdict(c) == dataclasses.asdict(w), tag


# ---------------------------------------------------------- exact rescore

def test_exact_rescore_matches_the_script(tmp_path):
    """One set of ``cpu_tiny`` weights (JAX-initialised, then moved off the
    initialiser's zero head by seeded noise) as an orbax snapshot for the
    script and converted for the port."""
    cfg = next(c for t, c, _ in run_scaling_ghz.experiments()
               if t == "cpu_tiny")
    n, t_steps = cfg.data.num_qubits, cfg.diffusion.num_timesteps
    state = jtrain.create_state(jax.random.key(0),
                                jbuild_model(cfg.model, n, t_steps),
                                cfg.train, n)
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.5 * rng.standard_normal(
            np.shape(x)).astype(np.float32), state.params)
    jpath, ppath = str(tmp_path / "jparams"), str(tmp_path / "params.pt")
    jckpt.save_params(jpath, jax.tree_util.tree_map(jax.numpy.asarray,
                                                    params))
    torch.save(params_from_flax(params), ppath)
    jout = str(tmp_path / "jax.jsonl")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(SCRIPTS, "exact_rescore.py"), "--tag",
         "cpu_tiny", "--params", jpath, "--also_sampled", "--out", jout],
        env=_jax_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    got = exact_rescore.rescore(exact_rescore.parse_args(
        ["--tag", "cpu_tiny", "--params", ppath, "--also_sampled",
         "--device", "cpu", "--out", str(tmp_path / "port.jsonl")]))
    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log
    want = read_rows(jout)
    assert [r["kind"] for r in got] == [r["kind"] for r in want] == [
        "exact_dist", "sampled_from_dist"]
    for g, w in zip(got, want):
        assert set(g) == set(w) | {"device"} and g["device"] == "cpu"
        assert g["shots_per_basis"] == w["shots_per_basis"] == (
            cfg.data.shots_infer)
    assert abs(got[0]["fidelity"] - want[0]["fidelity"]) <= MLE_TOL
    assert 0.3 < got[0]["fidelity"] < 0.999  # the noise moved the model
    # The sampled rows' shot noise, at the model's exact distribution.
    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.ops import diffusion as diff
    from ddqst_tpu_torch.ops.schedules import make_schedule
    from ddqst_tpu_torch.qsim import states
    from ddqst_tpu_torch.utils.checkpoint import restore_params

    model = restore_params(ppath, build_model(cfg.model, n, t_steps)).eval()
    with torch.no_grad():
        dist = diff.chain_distribution_all_bases(
            model, n, make_schedule(cfg.diffusion.schedule, t_steps),
            exact=cfg.diffusion.exact).double()
    target = torch.from_numpy(states.circuit_statevector(states.prep_circuit(
        cfg.data.state_type, n, cfg.data.rqc_depth,
        np.random.default_rng(0))))
    sd = chip_smoke.fidelity_shot_sd(n, target, dist / dist.sum(-1, True),
                                     cfg.data.shots_infer)
    assert sd > 0
    assert (abs(got[1]["fidelity"] - want[1]["fidelity"])
            <= FIDELITY_SDS * math.sqrt(2) * sd), (got[1], want[1], sd)
