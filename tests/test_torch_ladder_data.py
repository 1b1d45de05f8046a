"""The RQC-5 and GHZ-6 rungs' committed seed-0 data, against the JAX package.

For each of ``rqc5_auto`` and ``ghz6_auto`` (``ghz7_mle_hot`` in
``test_torch_ladder_data_ghz7.py``, on these tests): (a)
``examples/reference_data/<tag>_seed0.npz`` equals a fresh
``ddqst_tpu.pipeline.ensure_data_cache`` of ``scripts/run_scaling_ghz.py``'s
config at seed 0, array for array; (b) ``chip_smoke.scaling_rung(tag)`` is
that config; (c) the port reads the same counts from the file and its
raw-inversion fidelity equals ``ddqst_tpu``'s within 1e-6 (and
``chip_smoke.SCALING_DATA_JAX``'s record); (d) MLE on the raw counts capped
at 20 iterations gives ρ within 2e-4 of ``ddqst_tpu``'s, in as many
iterations.
"""

import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ddqst_tpu import pipeline as jpipe
from ddqst_tpu.ops import mle as jmle
from ddqst_tpu.ops.complexlib import to_complex
from ddqst_tpu_torch import pipeline as tpipe
from ddqst_tpu_torch.ops import metrics as tM
from ddqst_tpu_torch.ops import mle as tmle
from ddqst_tpu_torch.ops import pauli as tpauli

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAGS = ["rqc5_auto", "ghz6_auto"]
RAW_ATOL = 1e-6  # the raw (linear) inversion's fidelity
RHO_ATOL = 2e-4  # per entry of ρ, as tests/test_torch_mle.py holds the MLE
MLE_ITERS = 20


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_reference_data", os.path.join(ROOT, "tools",
                                            "make_reference_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_rung(tag: str, tmp_path_factory, mle_iters: int = MLE_ITERS) -> dict:
    """The rung's JAX config, a fresh JAX cache at seed 0, the committed
    file as each package reads it, and the MLE cap its test takes."""
    tool = _tool()
    cfg = tool.rung_cfg(tag)
    path = os.path.join(ROOT, chip_smoke.SCALING_DATA[tag])
    fresh = str(tmp_path_factory.mktemp(tag) / "fresh.npz")
    jpipe.ensure_data_cache(cfg, 0, fresh, log_fn=lambda m: None)
    return dict(tag=tag, n=cfg.data.num_qubits, tool=tool, cfg=cfg,
                path=path, fresh=fresh, jax=jpipe.load_data_cache(path),
                port=tpipe.load_data_cache(path, "cpu"), mle_iters=mle_iters)


@pytest.fixture(scope="module", params=TAGS)
def rung(request, tmp_path_factory):
    return make_rung(request.param, tmp_path_factory)


def test_committed_data_is_a_fresh_jax_cache(rung):
    n = rung["n"]
    with np.load(rung["path"]) as got, np.load(rung["fresh"]) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["bits"].shape == (3**n, rung["cfg"].data.shots_train, n)


def test_chip_smoke_rung_is_the_scripts(rung):
    want = dataclasses.asdict(rung["cfg"])
    got = dataclasses.asdict(chip_smoke.scaling_rung(rung["tag"]))
    for section in ("model", "diffusion", "train", "data"):
        common = set(want[section]) & set(got[section])
        assert {k: got[section][k] for k in common} == {
            k: want[section][k] for k in common}, section
    assert got["name"] == want["name"] == rung["tag"]


def test_port_reads_the_same_counts_and_raw_inversion(rung):
    jd, td, n = rung["jax"], rung["port"], rung["n"]
    np.testing.assert_array_equal(
        tmle.bits_to_counts(td.bits).numpy(),
        np.asarray(jmle.bits_to_counts(jd.bits)))
    np.testing.assert_array_equal(td.basis_labels, jd.basis_labels)
    want = rung["tool"].data_side(rung["cfg"], jd, mle_iterations=1)
    rho = tpauli.make_counts_inverter(n, td.basis_labels)(
        tmle.bits_to_counts(td.bits))
    got = float(tM.state_fidelity(torch.from_numpy(td.target), rho))
    assert abs(got - want["raw_fidelity"]) <= RAW_ATOL
    rec = chip_smoke.SCALING_DATA_JAX[rung["tag"]]
    assert abs(want["raw_fidelity"] - rec["raw_fidelity"]) <= RAW_ATOL


def test_mle_on_raw_capped_matches_jax(rung):
    jd, td, n = rung["jax"], rung["port"], rung["n"]
    iters = rung["mle_iters"]
    with rung["tool"].CountedSolve() as solve:
        want = jmle.make_mle(n, jd.basis_labels, readout_p=0.01,
                             iterations=iters)(
            jmle.bits_to_counts(jd.bits).astype(jnp.float32))
    info: dict = {}
    got = tmle.make_mle(n, td.basis_labels, readout_p=0.01,
                        iterations=iters)(tmle.bits_to_counts(td.bits), info)
    assert info["iterations"] == solve.iterations[0] == iters
    np.testing.assert_allclose(got.numpy(), np.asarray(to_complex(want)),
                               atol=RHO_ATOL)
