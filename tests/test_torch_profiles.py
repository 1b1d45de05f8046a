"""The port's counterparts of ``scripts/average_params.py``,
``eval_chain_ce_subset.py``, ``ghz8_sector_profile.py``,
``shadow_sector_profile.py`` and ``ghz8_eval_floor.py`` against those
scripts, on the CPU (the scripts run in this process, on JAX's CPU
backend).

- ``average_params``: three converted snapshots averaged by the port equal
  the JAX tree average, converted, bit for bit;
- ``eval_chain_ce_subset`` (``cpu_tiny``, random / ``--lowest`` /
  ``--no_z``): the same bases, the per-basis excess within ``EXCESS_TOL``;
- ``ghz8_sector_profile`` (``cpu_tiny``): the same three sectors, the rows'
  excess statistics within ``EXCESS_TOL``;
- ``shadow_sector_profile``: at a cut width within ``EXCESS_TOL`` of the
  script; at full width, the reference's CE snapshot on its data cache, the
  record's 48 bases and its first row within ``RECORD_ABS`` +
  ``RECORD_REL`` · |value| of ``examples/shadow_sector_profile.jsonl``;
- ``ghz8_eval_floor --smoke``: the same counts, both rows' fidelity, purity
  and entropy within ``FLOOR_TOL`` of the script's;
- each module's ``--help`` imports no JAX, and each raises without CUDA
  unless given ``--device cpu``.

Snapshots are JAX-initialised params moved off the initialiser's zero head
by seeded noise, saved by orbax for the script and converted
(``models.params_from_flax``) for the port.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddqst_tpu import train as jtrain
from ddqst_tpu.config import ModelConfig as JModelConfig
from ddqst_tpu.config import TrainConfig as JTrainConfig
from ddqst_tpu.models import build_model as jbuild_model
from ddqst_tpu.utils import checkpoint as jckpt
from ddqst_tpu_torch.campaigns import (average_params, eval_chain_ce_subset,
                                       ghz8_eval_floor, ghz8_sector_profile,
                                       read_rows, shadow_sector_profile)
from ddqst_tpu_torch.models import params_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
sys.path.insert(0, SCRIPTS)

import eval_chain_ce_subset as j_subset  # noqa: E402
import ghz8_eval_floor as j_floor  # noqa: E402
import ghz8_sector_profile as j_sectors  # noqa: E402
import run_scaling_ghz  # noqa: E402
import shadow_sector_profile as j_shadow  # noqa: E402

torch.set_num_threads(4)

EXCESS_TOL = 1e-5
FLOOR_TOL = 1e-4
RECORD_ABS, RECORD_REL = 1e-4, 1e-3
RECORD = os.path.join(ROOT, "examples", "shadow_sector_profile.jsonl")
REFERENCE_PARAMS = os.path.join(ROOT, "examples", "reference_params",
                                "dist_seg_ce_params.pt")
REFERENCE_DATA = os.path.join(ROOT, "shadow_work", "dist_seg_data.npz")
MODULES = ("average_params", "eval_chain_ce_subset", "ghz8_sector_profile",
           "shadow_sector_profile", "ghz8_eval_floor",
           "diag_segment_descent", "diag_floor_escape", "diag_hard_mining")


def _noisy(params, seed: int, scale: float = 0.5):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(
            np.shape(x)).astype(np.float32), params)


def _snapshot(tmp_path, name: str, params) -> tuple[str, str]:
    """``params`` (numpy leaves) as an orbax snapshot and a ``.pt``."""
    jpath, ppath = str(tmp_path / name), str(tmp_path / f"{name}.pt")
    jckpt.save_params(jpath, jax.tree_util.tree_map(jnp.asarray, params))
    torch.save(params_from_flax(params), ppath)
    return jpath, ppath


def _tiny_params(seed: int):
    cfg = next(c for t, c, _ in run_scaling_ghz.experiments()
               if t == "cpu_tiny")
    n, t_steps = cfg.data.num_qubits, cfg.diffusion.num_timesteps
    state = jtrain.create_state(jax.random.key(0),
                                jbuild_model(cfg.model, n, t_steps),
                                cfg.train, n)
    return _noisy(state.params, seed)


def _run_script(module, argv: list[str], monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__file__] + argv)
    module.main()


# ------------------------------------------------------------- averaging

def test_average_params_matches_the_jax_tree_average(tmp_path):
    trees = [_tiny_params(seed) for seed in (1, 2, 3)]
    paths = []
    for i, tree in enumerate(trees):
        paths.append(str(tmp_path / f"s{i}.pt"))
        torch.save(params_from_flax(tree), paths[-1])
    want = params_from_flax(jax.tree_util.tree_map(
        lambda *xs: np.asarray(sum(xs[1:], xs[0]) / len(xs)),
        *[jax.tree_util.tree_map(jnp.asarray, t) for t in trees]))
    out = str(tmp_path / "avg.pt")
    assert average_params.main(paths + ["--out", out, "--device", "cpu"]) == 0
    got = torch.load(out, weights_only=True)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="names differ"):
        average_params.average([got, {k: v for k, v in list(got.items())[1:]}])


# ------------------------------------------------------- subset chain CE

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A ``cpu_tiny`` snapshot and a [9, 4] target npz."""
    tmp = tmp_path_factory.mktemp("tiny")
    jpath, ppath = _snapshot(tmp, "snap", _tiny_params(5))
    probs = np.random.default_rng(11).dirichlet(
        np.full(4, 0.7), size=9).astype(np.float32)
    target = str(tmp / "target.npz")
    np.savez(target, target=probs)
    return jpath, ppath, target


class _Spy:
    """Records what the script hands to ``np.sort`` and ``np.percentile``
    (its basis selections and its per-basis excess)."""

    def __init__(self, monkeypatch):
        self.sorted, self.excess = [], []
        sort, percentile = np.sort, np.percentile

        def spy_sort(a, *args, **kw):
            out = sort(a, *args, **kw)
            if np.issubdtype(out.dtype, np.integer):
                self.sorted.append(out)
            return out

        def spy_percentile(a, *args, **kw):
            self.excess.append(np.asarray(a))
            return percentile(a, *args, **kw)

        monkeypatch.setattr(np, "sort", spy_sort)
        monkeypatch.setattr(np, "percentile", spy_percentile)


@pytest.mark.parametrize("flags", [[], ["--lowest"], ["--no_z"]],
                         ids=["random", "lowest", "no_z"])
def test_subset_excess_matches_the_script(tiny, flags, monkeypatch):
    jpath, ppath, target = tiny
    argv = ["--tag", "cpu_tiny", "--target", target, "--bases", "3",
            "--chunk", "2"] + flags
    spy = _Spy(monkeypatch)
    _run_script(j_subset, [jpath] + argv, monkeypatch)
    monkeypatch.undo()
    (want_bases,), (want,) = spy.sorted, spy.excess
    (got,) = eval_chain_ce_subset.run(eval_chain_ce_subset.parse_args(
        [ppath] + argv + ["--device", "cpu"]), log_fn=lambda m: None)
    np.testing.assert_array_equal(got["bases"], want_bases)
    np.testing.assert_allclose(got["excess_per_basis"], want,
                               atol=EXCESS_TOL, rtol=0)
    assert got["excess"] > 1e-3  # the noise moved the chain off the target


def test_sector_profile_matches_the_script(tiny, tmp_path, monkeypatch):
    jpath, ppath, target = tiny
    argv = ["--tag", "cpu_tiny", "--target", target, "--bases", "3",
            "--chunk", "2"]
    jout, pout = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    spy = _Spy(monkeypatch)
    _run_script(j_sectors, [jpath] + argv + ["--out", jout], monkeypatch)
    monkeypatch.undo()
    got = ghz8_sector_profile.run(ghz8_sector_profile.parse_args(
        [ppath] + argv + ["--out", pout, "--device", "cpu"]))
    secs = ghz8_sector_profile.sectors(
        eval_chain_ce_subset.load_target(target), 2, 3, 7)
    assert list(secs) == ["random", "low_ent", "xy"]
    for got_idx, want_idx in zip(secs.values(), spy.sorted[:3]):
        np.testing.assert_array_equal(got_idx, want_idx)
    want = read_rows(jout)
    assert read_rows(pout) == got and len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) | {"device"} and g["device"] == "cpu"
        assert (g["snap"], g["sector"], g["bases"]) == (
            "snap.pt", w["sector"], w["bases"])
        for k in ("excess_mean", "excess_q50", "excess_max"):
            assert abs(g[k] - w[k]) <= EXCESS_TOL, (k, g, w)


# ------------------------------------------------------ shadow profile

def test_shadow_profile_matches_the_script_at_a_cut_width(tmp_path,
                                                          monkeypatch):
    """N = 4, 12 bases of random labels, 40 shots a basis, a 16 / 32 / 1 /
    2 transformer at T = 10, the profile of 5 bases."""
    n, b, s = 4, 12, 40
    rng = np.random.default_rng(3)
    cache = str(tmp_path / "data.npz")
    np.savez(cache, bits=rng.integers(0, 2, (b, s, n)).astype(np.int8),
             basis_labels=rng.integers(0, 3, (b, n)),
             basis_idx=np.arange(b, dtype=np.int32),
             target=np.zeros(2**n, np.complex64),
             clean_probs=rng.dirichlet(np.full(2**n, 0.5), size=b))
    width = ["--embed", "16", "--hidden", "32", "--blocks", "1",
             "--heads", "2", "--timesteps", "10"]
    model = jbuild_model(JModelConfig(
        arch="transformer", input_encoding="token", embed_dim=16,
        hidden_dim=32, num_blocks=1, num_heads=2), n, 10)
    state = jtrain.create_state(jax.random.key(0), model, JTrainConfig(), n)
    jpath, ppath = _snapshot(tmp_path, "snap", _noisy(state.params, 7, 0.3))
    argv = ["--data", cache, "--bases", "5", "--chunk", "2"] + width
    jout, pout = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    _run_script(j_shadow, [jpath] + argv + ["--out", jout], monkeypatch)
    got = shadow_sector_profile.run(shadow_sector_profile.parse_args(
        [ppath] + argv + ["--out", pout, "--device", "cpu"]),
        log_fn=lambda m: None)
    want = read_rows(jout)
    assert read_rows(pout) == got and len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert set(g) == set(w) | {"device"}
        assert (g["basis"], g["n_z"]) == (w["basis"], w["n_z"])
        for k in ("kl_clean", "kl_counts"):
            assert abs(g[k] - w[k]) <= EXCESS_TOL, (k, g, w)
    assert max(r["kl_clean"] for r in got) > 1e-2


def within_record(got: float, want: float) -> bool:
    return abs(got - want) <= RECORD_ABS + RECORD_REL * abs(want)


def test_shadow_profile_reproduces_the_record_at_full_width(tmp_path):
    """The reference's CE snapshot on its cache (transformer 128 / 512 / 4
    / 4, N = 10, T = 100): the record's bases, and its first row."""
    from ddqst_tpu_torch import pipeline

    record = read_rows(RECORD)
    args = shadow_sector_profile.parse_args(
        [REFERENCE_PARAMS, "--data", REFERENCE_DATA, "--device", "cpu",
         "--out", str(tmp_path / "port.jsonl")])
    b_all = pipeline.load_data_cache(REFERENCE_DATA).bits.shape[0]
    sel = shadow_sector_profile.select(b_all, args.bases, args.seed)
    assert sel.tolist() == [r["basis"] for r in record] and len(sel) == 48
    (got,) = shadow_sector_profile.run(args, log_fn=lambda m: None, limit=1)
    want = record[0]
    assert (got["basis"], got["n_z"]) == (want["basis"], want["n_z"])
    for k in ("kl_clean", "kl_counts"):
        assert within_record(got[k], want[k]), (k, got, want)


# --------------------------------------------------------- eval floor

def test_eval_floor_smoke_matches_the_script(monkeypatch, capsys, tmp_path):
    from ddqst_tpu.ops.complexlib import from_complex
    from ddqst_tpu.ops.pauli import all_basis_labels
    from ddqst_tpu.qsim import measure, states

    rots = from_complex(jnp.asarray(measure.rotation_unitaries(
        all_basis_labels(3))))
    psis = from_complex(jnp.asarray(states.ghz_state(3))[None, :])
    jprobs = np.asarray(measure.batched_probs_pure(psis, rots))[0]
    # The two packages' Born probabilities differ in the last bits, which
    # move numpy's multinomial draws: the port's rows are computed on the
    # script's probabilities, so both see the same counts.
    probs = ghz8_eval_floor.smoke_probs()
    np.testing.assert_allclose(probs, jprobs, atol=1e-6, rtol=0)
    _run_script(j_floor, ["--smoke"], monkeypatch)
    want = [json.loads(line.split(" ", 1)[1]) for line in
            capsys.readouterr().out.splitlines()
            if line.startswith("[eval_floor] ")]
    got = ghz8_eval_floor.floor_rows(jprobs, 3000, 0, torch.device("cpu"))
    assert [r["kind"] for r in got] == [r["kind"] for r in want] == [
        "sampled", "exact"]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("fidelity", "purity", "vn_entropy"):
            assert abs(g[k] - w[k]) <= FLOOR_TOL, (k, g, w)
    port = ghz8_eval_floor.run(ghz8_eval_floor.parse_args(
        ["--smoke", "--device", "cpu"]))
    assert [set(r) for r in port] == [set(w) | {"device"} for w in want]
    assert [r["kind"] for r in port] == ["sampled", "exact"]
    assert abs(port[1]["fidelity"] - want[1]["fidelity"]) <= FLOOR_TOL
    np.savez(tmp_path / "t.npz", target=probs)
    with pytest.raises(ValueError, match="GHZ-8 target"):
        ghz8_eval_floor.main(["--target", str(tmp_path / "t.npz"),
                              "--device", "cpu"])


# ------------------------------------------------------------ entry points

@pytest.mark.parametrize("module", MODULES)
def test_help_imports_no_jax(module):
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['{module}', '--help']\n"
        "try:\n"
        f"    runpy.run_module('ddqst_tpu_torch.campaigns.{module}', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ddqst_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "ok"


@pytest.mark.parametrize("module,argv", [
    ("average_params", ["a.pt", "--out", "avg.pt"]),
    ("eval_chain_ce_subset", ["a.pt", "--target", "t.npz"]),
    ("ghz8_sector_profile", ["a.pt", "--target", "t.npz"]),
    ("shadow_sector_profile", ["a.pt", "--data", "d.npz"]),
    ("ghz8_eval_floor", ["--smoke"]),
    ("diag_segment_descent", []),
    ("diag_floor_escape", []),
    ("diag_hard_mining", []),
])
def test_entry_points_need_cuda_unless_cpu_is_asked(module, argv, tmp_path,
                                                    monkeypatch):
    import importlib

    mod = importlib.import_module(f"ddqst_tpu_torch.campaigns.{module}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    out = [] if module in ("average_params", "eval_chain_ce_subset") else [
        "--out", str(tmp_path / "rows")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv + out)
    assert not os.listdir(tmp_path)


def test_chip_profile_check_holds_rows_to_the_record():
    """``chip_smoke.profile_gaps``, the check of phase ``profiles``: the
    record against itself has no gap; a row inside PROFILE_ABS +
    PROFILE_REL · |value| passes, one beyond it or on another basis fails."""
    import chip_smoke

    record = read_rows(RECORD)
    gaps = chip_smoke.profile_gaps(record[:3], record)
    assert all(g["max_abs_gap"] == 0 for g in gaps.values())
    bound = RECORD_ABS + RECORD_REL * abs(record[0]["kl_counts"])
    inside = [dict(record[0], kl_counts=record[0]["kl_counts"] + 0.9 * bound)]
    assert chip_smoke.profile_gaps(inside, record)["kl_counts"][
        "max_share_of_bound"] == pytest.approx(0.9)
    for bad in (dict(record[0], kl_counts=record[0]["kl_counts"] + 1.1 * bound),
                dict(record[0], basis=record[0]["basis"] + 1)):
        with pytest.raises(RuntimeError, match="check failed"):
            chip_smoke.profile_gaps([bad], record)
