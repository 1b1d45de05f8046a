"""The port's campaign drivers (``ddqst_tpu_torch.campaigns``) against the
JAX package's scripts, on the CPU.

- ``scaling.experiments()`` and ``shadow_scale.make_cfg`` equal the
  scripts' configs field by field;
- ``cpu_tiny`` through ``run_scaling_ghz.py`` and through the port's
  ``scaling`` on one JAX-written data file: the same row keys (and the
  port's ``device``), raw inversion within ``RAW_TOL``, MLE on the raw
  counts within ``MLE_TOL``, the generative fidelity within
  ``FIDELITY_SDS`` shot-noise standard deviations of the difference of two
  runs (``chip_smoke.fidelity_shot_sd`` at the port's sample distribution,
  times √2);
- rerun-safety and ``--probe`` (no row);
- the segments driver on ``cpu_tiny`` with its children on the CPU: the
  chain of snapshots, the MLE target against ``scripts/make_mle_target.py``
  on the same data within ``TARGET_TOL``, resume from ``--start_segment``,
  a failing or timed-out child ending the campaign with no row and no retry;
- every entry point raises without CUDA unless given ``--device cpu``;
- ``chip_smoke.py --time-kernels DIR`` imports DIR's kernels.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from ddqst_tpu_torch.campaigns import (read_rows, scaling, segments,
                                       shadow_scale)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
sys.path.insert(0, SCRIPTS)

import run_scaling_ghz  # noqa: E402
import run_shadow_scale  # noqa: E402

torch.set_num_threads(1)

RAW_TOL = 1e-5  # the rows round to 5 decimals: equal data, equal rounding
MLE_TOL = 1e-4
FIDELITY_SDS = 4.0
TARGET_TOL = 1e-5
SCRIPT_TAGS = [t for t, _, _ in run_scaling_ghz.experiments()]
ROW_KEYS = {"tag", "num_qubits", "fidelity", "raw_fidelity",
            "raw_fidelity_mitigated", "trace_distance", "note", "wall_s"}


def _jax_env():
    env = dict(os.environ)
    env.update(DDQST_CPU="1", JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)  # the test process's forced CPU mesh
    return env


def _port_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env.pop(segments.FAIL_ENV, None)
    return env


def test_experiments_order_and_notes_match_the_script():
    got = [(t, n) for t, _, n in scaling.experiments()]
    assert got == [(t, n) for t, _, n in run_scaling_ghz.experiments()]
    assert len(got) == 25


@pytest.mark.parametrize("tag", SCRIPT_TAGS)
def test_experiment_config_matches_the_script(tag):
    want = next(c for t, c, _ in run_scaling_ghz.experiments() if t == tag)
    got, _ = scaling.experiment(tag)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("args,kw", [
    (("defaults",), {}),
    (("dist_seg",), dict(max_bases=300)),
    (("dist1k",), dict(max_bases=300, distill_steps=1000, distill_lr=3e-4,
                       distill_basis_batch=32, distill_steps_per_call=10,
                       distill_val=0.0, distill_salt=3,
                       distill_hard_frac=0.5, mitigate=True,
                       sampler="exact", epochs=500, embed=256)),
])
def test_shadow_make_cfg_matches_the_script(args, kw):
    assert (dataclasses.asdict(shadow_scale.make_cfg(*args, **kw))
            == dataclasses.asdict(run_shadow_scale.make_cfg(*args, **kw)))


@pytest.fixture(scope="module")
def jax_tiny(tmp_path_factory):
    """``cpu_tiny``'s seed-0 data and MLE target from
    ``scripts/make_mle_target.py``, then ``run_scaling_ghz.py --only
    cpu_tiny`` on that data: (workdir, data file, the script's row)."""
    work = tmp_path_factory.mktemp("jax_tiny")
    proc = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "make_mle_target.py"),
         "--tag", "cpu_tiny", "--workdir", str(work)],
        env=_jax_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = str(work / "cpu_tiny_data.npz")
    out = str(work / "rows.jsonl")
    proc = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "run_scaling_ghz.py"),
         "--only", "cpu_tiny", "--data_cache", data, "--out", out],
        env=_jax_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (row,) = read_rows(out)
    return work, data, row


def test_cpu_tiny_row_against_the_script(jax_tiny, tmp_path):
    _, data, want = jax_tiny
    out = str(tmp_path / "rows.jsonl")
    argv = ["--only", "cpu_tiny", "--device", "cpu", "--data_cache", data,
            "--out", out]
    ((rec, res),) = scaling.run(scaling.parse_args(argv))
    (got,) = read_rows(out)
    assert got == rec
    assert set(got) == ROW_KEYS | {"device"} and set(want) == ROW_KEYS
    assert got["device"] == "cpu"
    assert {k: got[k] for k in ("tag", "num_qubits", "note")} == {
        k: want[k] for k in ("tag", "num_qubits", "note")}
    assert abs(got["raw_fidelity"] - want["raw_fidelity"]) <= RAW_TOL + 1e-12
    if want["raw_fidelity_mitigated"] is None:  # noise 'ideal': no mitigation
        assert got["raw_fidelity_mitigated"] is None
    else:
        assert (abs(got["raw_fidelity_mitigated"]
                    - want["raw_fidelity_mitigated"]) <= MLE_TOL)
    # The shot-noise scale of the generative fidelity at the port's sample
    # distribution; two independent runs differ with √2 times it.
    samples = res["samples"]
    n, shots = samples.shape[-1], samples.shape[1]
    idx = (samples.long() * (1 << torch.arange(n))).sum(-1)
    dist = torch.stack([torch.bincount(r, minlength=2**n) for r in idx])
    sd = chip_smoke.fidelity_shot_sd(
        n, torch.from_numpy(res["target"]), dist.double() / shots, shots)
    assert sd > 0
    assert (abs(got["fidelity"] - want["fidelity"])
            <= FIDELITY_SDS * math.sqrt(2) * sd), (got, want, sd)
    assert 0.0 <= got["fidelity"] <= 1.0


def test_rerun_adds_no_row_and_probe_writes_none(jax_tiny, tmp_path,
                                                 monkeypatch):
    _, data, _ = jax_tiny
    out = str(tmp_path / "rows.jsonl")
    argv = ["--only", "cpu_tiny", "--device", "cpu", "--data_cache", data,
            "--out", out]
    assert scaling.main(argv) == 0
    assert scaling.main(argv) == 0
    assert len(read_rows(out)) == 1
    # cpu_tiny runs only when named.
    tiny = [e for e in scaling.experiments() if e[0] == "cpu_tiny"]
    with monkeypatch.context() as m:
        m.setattr(scaling, "experiments", lambda: iter(tiny))
        assert scaling.run(scaling.parse_args(
            ["--device", "cpu", "--out", str(tmp_path / "none.jsonl")])) == []
    probe_out = str(tmp_path / "probe.jsonl")
    ((rec, res),) = scaling.run(scaling.parse_args(
        ["--probe", "--only", "cpu_tiny", "--device", "cpu",
         "--data_cache", data, "--out", probe_out]))
    assert rec is None and not os.path.exists(probe_out)
    cfg, _ = scaling.experiment("cpu_tiny")
    assert len(res["losses"]) == 1  # one CE epoch
    assert len(res["ft_losses"]) == min(
        cfg.train.chain_finetune_steps, 2 * cfg.train.chain_steps_per_call)
    assert res["samples"].shape == (9, cfg.data.shots_infer, 2)


def _segments(work, out, *extra, env=None, timeout=600):
    return subprocess.run(
        [sys.executable, "-m", "ddqst_tpu_torch.campaigns.segments",
         "--tag", "cpu_tiny", "--segments", "2", "--steps_per_segment", "2",
         "--device", "cpu", "--workdir", str(work), "--out", str(out),
         *extra], cwd=ROOT, env=env or _port_env(), capture_output=True,
        text=True, timeout=timeout)


def _labels(stdout):
    return [line.split("] ", 1)[1].rsplit(":", 1)[0]
            for line in stdout.splitlines()
            if line.startswith("[segments]") and line.endswith("starting")]


def test_segments_chain_target_and_resume(jax_tiny, tmp_path):
    jwork, data, _ = jax_tiny
    work, out = tmp_path / "work", tmp_path / "rows.jsonl"
    proc = _segments(work, out, "--data_cache", data)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert _labels(proc.stdout) == ["ce segment -1", "distill segment 0",
                                    "distill segment 1", "eval segment 2"]
    snaps = {s: segments.snapshot(str(work), "cpu_tiny", s)
             for s in (-1, 0, 1)}
    assert all(os.path.exists(p) for p in snaps.values())
    (row,) = read_rows(out)
    assert row["tag"] == "cpu_tiny_seg2x2"
    assert row["distill_steps_actual"] == 4 and row["device"] == "cpu"
    assert 0.0 <= row["fidelity"] <= 1.0
    with open(work / "cpu_tiny_segments.jsonl") as f:
        segs = [json.loads(line) for line in f]
    assert [s["segment"] for s in segs] == [0, 1]
    # Segment 1 starts where segment 0 ended.
    assert segs[1]["ce_before"] == pytest.approx(segs[0]["ce_after"],
                                                 abs=1e-6)
    # Segment 0's MLE target against the JAX package's on the same data.
    with np.load(work / "cpu_tiny_target.npz") as z:
        got = z["target"]
    with np.load(jwork / "cpu_tiny_target.npz") as z:
        want = z["target"]
    assert got.shape == want.shape == (9, 4)
    np.testing.assert_allclose(got, want, atol=TARGET_TOL, rtol=0)

    before = {s: os.path.getmtime(p) for s, p in snaps.items()}
    proc = _segments(work, out, "--data_cache", data, "--start_segment", "1")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert _labels(proc.stdout) == ["distill segment 1", "eval segment 2"]
    after = {s: os.path.getmtime(p) for s, p in snaps.items()}
    assert after[-1] == before[-1] and after[0] == before[0]
    assert after[1] > before[1]
    assert [r["tag"] for r in read_rows(out)] == ["cpu_tiny_seg2x2"] * 2


@pytest.mark.parametrize("how", ["injected", "timeout"])
def test_segments_failing_child_ends_the_campaign(tmp_path, how):
    """A role that fails (``DDQST_FAIL_ROLE``) or outlives
    ``--segment_timeout`` ends the driver non-zero with its stderr's tail:
    no retry, no later role, no row. Injected: the datagen child
    (``--data_cache auto``) fills the cache first."""
    work, out = tmp_path / "work", tmp_path / "rows.jsonl"
    env = _port_env()
    if how == "injected":
        env[segments.FAIL_ENV] = "ce"
        proc = _segments(work, out, env=env)
    else:
        proc = _segments(work, out, "--data_cache", "",
                         "--segment_timeout", "1")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert not os.path.exists(out)
    labels = _labels(proc.stdout)
    if how == "injected":
        assert labels == ["datagen", "ce segment -1"]
        assert (work / "cpu_tiny_data.npz").exists()
        assert not os.path.exists(segments.snapshot(str(work), "cpu_tiny",
                                                    -1))
        assert "injected failure in role 'ce'" in proc.stdout
    else:
        assert labels == ["ce segment -1"]
        assert "killed after 1 s (--segment_timeout)" in proc.stdout
    assert "resume with --start_segment" in proc.stdout


@pytest.mark.parametrize("module,argv", [
    (scaling, ["--only", "cpu_tiny"]),
    (shadow_scale, ["--tag", "x", "--epochs", "1"]),
    (segments, ["--tag", "cpu_tiny"]),
])
def test_entry_points_need_cuda_unless_cpu_is_asked(module, argv, tmp_path,
                                                    monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv + ["--out", str(tmp_path / "rows.jsonl"),
                            *(["--workdir", str(tmp_path)]
                              if module is segments else [])])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("first", ["", "import ddqst_tpu_torch"])
def test_time_kernels_imports_the_named_checkout(tmp_path, first):
    """``chip_smoke.py --time-kernels DIR`` times DIR's kernels: importing
    the script imports nothing of the package, so ``kernels_of(DIR)``
    finds DIR's ``cuda_kernels``; a package imported before it would shadow
    DIR, and ``kernels_of`` then raises rather than time the wrong tree."""
    ops = tmp_path / "ddqst_tpu_torch" / "ops"
    ops.mkdir(parents=True)
    for f in (ops.parent / "__init__.py", ops / "__init__.py",
              ops / "cuda_kernels.py"):
        f.write_text("")
    code = (f"{first}\nimport chip_smoke, sys\n"
            "assert 'ddqst_tpu_torch' not in sys.modules or "
            f"{bool(first)}\n"
            f"print(chip_smoke.kernels_of({str(tmp_path)!r}).__file__)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=_port_env(), capture_output=True, text=True,
                          timeout=120)
    if first:
        assert proc.returncode != 0
        assert "not that checkout's" in proc.stderr
    else:
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip() == str(ops / "cuda_kernels.py")
