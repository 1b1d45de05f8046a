"""The port's bench (``ddqst_tpu_torch.bench``) against the JAX package's
``bench.py``, on the CPU.

``bench.py`` runs unchanged with its heavy calls replaced by stubs that
record their arguments (``train.create_state`` / ``_run_epoch``,
``diffusion.sample_all_bases`` / ``sample_for_bases_tables``,
``pipeline.run_experiment``); the port's bench runs the same way with its
own counterparts stubbed. The two plans must agree: the training data and
batch, the calls and repeats of each part, the shots, the shadow labels and
table chunk, the recipes' configs and seeds; and the port's record carries
every key of ``bench.py``'s. Then the port's bench runs for real at a tiny
width and depth, a failing part ends the run, and a CUDA device without a
card raises.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import os
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ddqst_tpu import pipeline as jpipe
from ddqst_tpu import train as jtrain
from ddqst_tpu.ops import diffusion as jdiff
from ddqst_tpu_torch import bench, pipeline, train
from ddqst_tpu_torch.config import get_preset
from ddqst_tpu_torch.ops import diffusion

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULT = dict(fidelity=0.99, raw_fidelity=0.9, raw_fidelity_mitigated=0.995,
              timings={}, train_steps=1)


def _lines(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def _section(cfg, name: str) -> dict:
    return dataclasses.asdict(getattr(cfg, name))


def _same_config(got, want) -> None:
    """The port's config equals the JAX one on every field both have."""
    assert got.name == want.name
    for name in ("model", "diffusion", "train", "data"):
        g, w = _section(got, name), _section(want, name)
        common = set(g) & set(w)
        assert {k: g[k] for k in common} == {k: w[k] for k in common}, name


@pytest.fixture(scope="module")
def jax_plan(tmp_path_factory):
    """``bench.py``'s main with its heavy calls stubbed: what each got, and
    its record."""
    calls = {k: [] for k in ("state", "epoch", "sample", "tables", "run")}

    class State:
        params = {}

        @staticmethod
        def apply_fn(*args):
            raise AssertionError("the stubs never run the model")

    def create_state(key, model, cfg, num_qubits, total_steps=None):
        calls["state"].append(dict(num_qubits=num_qubits,
                                   total_steps=total_steps))
        return State()

    def run_epoch(state, key, bits, basis, schedule, batch_size, *a, **kw):
        calls["epoch"].append(dict(bits=np.asarray(bits),
                                   basis=np.asarray(basis), batch=batch_size))
        return state, jnp.float32(0.5)

    def sample_all_bases(key, apply_fn, params, n, shots, schedule, **kw):
        calls["sample"].append((n, shots, kw.get("walk", "auto")))
        return jnp.zeros((3**n, 2, n), jnp.int8)

    def tables(key, apply_fn, params, labels, shots, schedule, **kw):
        calls["tables"].append(dict(labels=np.asarray(labels), shots=shots,
                                    max_table_rows=kw["max_table_rows"]))
        return jnp.zeros((labels.shape[0], 2, labels.shape[1]), jnp.int8)

    def run_experiment(cfg, seed=0, log_fn=print, **kw):
        calls["run"].append((cfg, seed))
        return dict(RESULT)

    spec = importlib.util.spec_from_file_location(
        "reference_bench", os.path.join(ROOT, "bench.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR",
                  str(tmp_path_factory.mktemp("jax_cache")))
        mp.setattr(jtrain, "create_state", create_state)
        mp.setattr(jtrain, "_run_epoch", run_epoch)
        mp.setattr(jdiff, "sample_all_bases", sample_all_bases)
        mp.setattr(jdiff, "sample_for_bases_tables", tables)
        mp.setattr(jpipe, "run_experiment", run_experiment)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            ref.main()
    return calls, _lines(out.getvalue())[-1]


def _stub_port(monkeypatch) -> dict:
    """The port's counterparts of the stubbed calls, recording theirs."""
    calls = {k: [] for k in ("epoch", "sample", "tables", "run")}

    def run_epoch(model, opt, lr_fn, step0, gen, bits, basis, schedule,
                  batch_size, *a, **kw):
        calls["epoch"].append(dict(bits=bits.numpy(), basis=basis.numpy(),
                                   batch=batch_size))
        return torch.tensor(0.5), bits.shape[0] // batch_size

    def sample_all_bases(gen, model, n, shots, schedule, walk="auto",
                         device=None, timings=None, **kw):
        calls["sample"].append((n, shots, walk))
        return torch.zeros((3**n, 2, n), dtype=torch.int8)

    def tables(gen, model, labels, shots, schedule, max_table_rows=0,
               device=None, timings=None, **kw):
        calls["tables"].append(dict(labels=labels.numpy(), shots=shots,
                                    max_table_rows=max_table_rows))
        return torch.zeros((labels.shape[0], 2, labels.shape[1]),
                           dtype=torch.int8)

    def run_experiment(cfg, seed=0, log_fn=print, device=None, **kw):
        calls["run"].append((cfg, seed))
        return dict(RESULT)

    monkeypatch.setattr(train, "_run_epoch", run_epoch)
    monkeypatch.setattr(diffusion, "sample_all_bases", sample_all_bases)
    monkeypatch.setattr(diffusion, "sample_for_bases_tables", tables)
    monkeypatch.setattr(pipeline, "run_experiment", run_experiment)
    return calls


def test_plan_equals_bench_py(jax_plan, monkeypatch, capsys):
    want, want_record = jax_plan
    got = _stub_port(monkeypatch)
    assert bench.main(["--device", "cpu"]) == 0
    lines = _lines(capsys.readouterr().out)
    record, parts = lines[-1], {k: v for line in lines[:-1]
                                for k, v in line.items()}

    # Training: the same data, batch and epochs (one warm, 3 x 5 timed).
    assert len(got["epoch"]) == len(want["epoch"]) == 1 + 3 * 5
    for g, w in zip(got["epoch"], want["epoch"]):
        np.testing.assert_array_equal(g["bits"], w["bits"])
        np.testing.assert_array_equal(g["basis"], w["basis"])
        assert g["bits"].dtype == w["bits"].dtype == np.int8
        assert g["batch"] == w["batch"] == 1024
    assert want["epoch"][0]["bits"].shape == (1024 * 40, 3)
    assert parts["train"]["steps_per_epoch"] == 40
    assert (parts["train"]["epochs"], len(parts["train"]["per_sec_repeats"])
            ) == (5, 3)
    assert [s["num_qubits"] for s in want["state"]] == [3, 10]
    assert all(s["total_steps"] is None for s in want["state"])

    # Sampling and the 10^6-chain walk: bench.py's warm call and timed
    # repeats, then the port's one untimed call for the tables / walk split.
    assert Counter(want["sample"]) == {(3, 5000, "auto"): 4,
                                       (3, 37037, "pallas"): 6}
    # On the CPU the port's walk part takes 'auto' (the walk's plain
    # version); on a card 'cuda' (tests/test_torch_cuda.py,
    # test_bench_walk_part_demands_the_cuda_walk).
    assert Counter(got["sample"]) == {(3, 5000, "auto"): 5,
                                      (3, 37037, "auto"): 7}
    assert parts["sampling"]["repeats"] == 4 - 1
    assert parts["walk_1m"]["repeats"] == 6 - 1
    assert parts["sampling"]["work"] == 27 * 5000
    assert parts["walk_1m"]["work"] == 27 * 37037

    # The shadow part: the same 50 label rows, shots and table chunk.
    assert len(want["tables"]) == 1 + 3 and len(got["tables"]) == 1 + 3 + 1
    assert parts["shadow"]["repeats"] == 3
    for g in got["tables"]:
        w = want["tables"][0]
        np.testing.assert_array_equal(g["labels"], w["labels"])
        assert w["labels"].shape == (50, 10)
        assert g["shots"] == w["shots"] == 2000
        assert g["max_table_rows"] == w["max_table_rows"] == 1 << 20

    # The recipes: GHZ-3 at seeds 0-2, then RQC-3 at seed 0, each config
    # field by field.
    assert [s for _, s in got["run"]] == [s for _, s in want["run"]] == [
        0, 1, 2, 0]
    for (g, _), (w, _) in zip(got["run"], want["run"]):
        _same_config(g, w)
    _same_config(bench.bench_recipe("ghz", 300, 800), want["run"][0][0])
    _same_config(bench.bench_recipe("rqc", 300, 800), want["run"][3][0])

    # The record: every key of bench.py's, the quality keys as it makes
    # them from the same results.
    assert set(want_record) <= set(record), set(want_record) - set(record)
    for k in ("ghz3_fidelity", "ghz3_fidelity_seeds", "ghz3_raw_fidelity",
              "ghz3_mle_fidelity", "ghz3_fidelity_reference",
              "rqc3_fidelity", "metric", "unit"):
        assert record[k] == want_record[k], k
    assert record["device"]["type"] == "cpu"


@pytest.fixture
def tiny(monkeypatch):
    """The port's bench at a tiny width, depth and size on the CPU."""
    def small(cfg):
        return cfg.replace(
            model=dataclasses.replace(cfg.model, embed_dim=8, hidden_dim=16,
                                      num_blocks=1),
            diffusion=dataclasses.replace(cfg.diffusion, num_timesteps=8),
            train=dataclasses.replace(cfg.train, batch_size=64))

    def preset(name):
        cfg = small(get_preset(name))
        if name == "shadow_transformer":
            cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                                       num_qubits=4))
        return cfg

    recipe = bench.bench_recipe

    def small_recipe(kind, epochs, steps):
        cfg = recipe(kind, epochs, steps)
        return small(cfg).replace(data=dataclasses.replace(
            cfg.data, shots_train=300, shots_infer=500))

    monkeypatch.setattr(bench, "get_preset", preset)
    monkeypatch.setattr(bench, "bench_recipe", small_recipe)
    for name, value in (("TRAIN_STEPS_PER_EPOCH", 3), ("TRAIN_EPOCHS", 2),
                        ("SAMPLING_SHOTS", 50), ("WALK_SHOTS", 70),
                        ("SHADOW_BASES", 3), ("SHADOW_SHOTS", 40)):
        monkeypatch.setattr(bench, name, value)
    return ["--device", "cpu", "--depth", "2", "2", "--ghz-seeds", "2"]


def test_tiny_run_on_the_cpu(tiny, capsys):
    assert bench.main(tiny) == 0
    lines = _lines(capsys.readouterr().out)
    record = lines[-1]
    assert {"cut": "num_epochs 300 -> 2"} in lines
    assert {"cut": "ghz_seeds 3 -> 2"} in lines
    for k in ("value", "train_steps_per_sec_min", "sampled_bitstrings_per_sec",
              "sampled_bitstrings_per_sec_min",
              "pallas_walk_bitstrings_per_sec",
              "pallas_walk_bitstrings_per_sec_min",
              "shadow_transformer_bitstrings_per_sec",
              "shadow_transformer_bitstrings_per_sec_min"):
        assert math.isfinite(record[k]) and record[k] > 0, k
    assert len(record["pallas_walk_repeats"]) == 5
    fids = [record[k] for k in ("ghz3_fidelity", "ghz3_raw_fidelity",
                                "ghz3_mle_fidelity", "rqc3_fidelity")]
    fids += record["ghz3_fidelity_seeds"]
    assert len(record["ghz3_fidelity_seeds"]) == 2
    assert all(0 <= f <= 1 for f in fids), fids
    assert record["ghz3_fidelity"] == min(record["ghz3_fidelity_seeds"])
    assert record["quality"] == dict(epochs=2, chain_steps=2, ghz_seeds=2)
    assert record["device"]["type"] == "cpu"
    recipes = [line["recipe"] for line in lines if "recipe" in line]
    assert [(r["kind"], r["seed"]) for r in recipes] == [
        ("ghz", 0), ("ghz", 1), ("rqc", 0)]
    assert all(r["distill_steps"] <= 2 for r in recipes)


def test_skip_quality_marks_its_keys_null(tiny, monkeypatch, capsys):
    def run_experiment(*a, **kw):
        raise AssertionError("no recipe runs")

    monkeypatch.setattr(pipeline, "run_experiment", run_experiment)
    assert bench.main(tiny + ["--skip-quality"]) == 0
    lines = _lines(capsys.readouterr().out)
    record = lines[-1]
    assert record["quality"].startswith("skipped")
    for k in ("ghz3_fidelity", "ghz3_fidelity_seeds", "ghz3_raw_fidelity",
              "ghz3_mle_fidelity", "rqc3_fidelity"):
        assert record[k] is None, k
    assert not any("cut" in line for line in lines)
    assert record["value"] > 0


@pytest.mark.parametrize("owner,name", [
    (bench, "measure_train_rate"), (train, "_run_epoch"),
    (diffusion, "sample_all_bases"), (diffusion, "sample_for_bases_tables"),
    (pipeline, "run_experiment")])
def test_a_failing_part_ends_the_run(tiny, owner, name, monkeypatch, capsys):
    def fail(*a, **kw):
        raise RuntimeError(f"{name} failed")

    monkeypatch.setattr(owner, name, fail)
    with pytest.raises(RuntimeError, match=f"{name} failed"):
        bench.main(tiny)
    assert not any("metric" in line for line in
                   _lines(capsys.readouterr().out))


def test_cuda_without_a_card_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])
    assert capsys.readouterr().out == ""


def test_throughput_synchronises_before_the_clock_stops(monkeypatch):
    events = []
    monkeypatch.setattr(bench, "synchronize", lambda dev: events.append(
        ("sync", dev.type)))
    med, low, reps = bench._throughput(lambda: events.append("call"), 10.0,
                                       3, torch.device("cpu"))
    assert events == ["call", ("sync", "cpu")] * 3
    assert len(reps) == 3 and low == min(reps) and med == sorted(reps)[1]
    assert all(r > 0 for r in reps)


def test_chip_smoke_keeps_no_copy_of_the_recipe():
    assert not hasattr(chip_smoke, "bench_recipe")
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        assert "def bench_recipe" not in f.read()
