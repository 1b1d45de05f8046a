"""The port's driver of ``scripts/run_shadow_segments.py``
(``campaigns.shadow_segments``) against the script, on the CPU.

- each role's config equals the script's ``_cfg_for`` for several flag
  sets;
- at a tiny shadow configuration (the N=10 recipe cut to N = 7, T = 10, 3
  bases, width 16) the driver and the script's roles on one JAX-written
  data cache: the chain of snapshots, the steps log's and the eval row's
  keys (and what depends on the data alone) equal the script's, and resume
  from ``--start_segment 1``;
- a failing or timed-out child ends the run with no row.
"""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from ddqst_tpu import pipeline as jpipe
from ddqst_tpu_torch.campaigns import read_rows, segments, shadow_segments

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import run_shadow_scale  # noqa: E402
import run_shadow_segments  # noqa: E402

torch.set_num_threads(1)

DATA_TOL = 1e-5  # metrics of the data alone, rounded to 5 decimals


def _port_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env.pop(segments.FAIL_ENV, None)
    return env


SHADOW_FLAG_SETS = [
    [],
    ["--max_bases", "100", "--epochs", "20", "--embed", "64", "--hidden",
     "256", "--blocks", "2", "--heads", "2"],
    ["--shots_infer", "2000", "--shots_train", "512",
     "--distill_basis_batch", "32", "--distill_steps_per_call", "10",
     "--distill_val", "0.0", "--hard_frac", "0.5"],
]


@pytest.mark.parametrize("flags", SHADOW_FLAG_SETS)
@pytest.mark.parametrize("steps,salt", [(0, 0), (300, 1), (7, 4)])
def test_shadow_role_config_matches_the_script(flags, steps, salt):
    args = shadow_segments.parse_args(flags)
    got = shadow_segments.cfg_for(args, distill_steps=steps,
                                  distill_salt=salt)
    want = run_shadow_segments._cfg_for(args, distill_steps=steps,
                                        distill_salt=salt)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _tiny(make_cfg):
    """The N=10 shadow recipe cut to a CPU test: N = 7 (the shadow route
    with sampled bases), RQC depth 3, T = 10."""
    def cut(*a, **kw):
        cfg = make_cfg(*a, **kw)
        return cfg.replace(
            diffusion=dataclasses.replace(cfg.diffusion, num_timesteps=10),
            data=dataclasses.replace(cfg.data, num_qubits=7, rqc_depth=3))
    return cut


TINY_FLAGS = ["--tag", "tiny", "--segments", "2", "--steps_per_segment", "2",
              "--epochs", "2", "--embed", "16", "--hidden", "32", "--blocks",
              "1", "--heads", "2", "--max_bases", "3", "--shots_train", "400",
              "--shots_infer", "200", "--distill_basis_batch", "2",
              "--distill_steps_per_call", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def shadow_tiny(tmp_path_factory):
    """One JAX-written data cache; the script's roles (ce, two segments of
    two steps, eval) in this process on it, and the port's driver with its
    children in this process too: (port workdir, its labels, the script's
    steps log and row, the port's, the data cache)."""
    tmp = tmp_path_factory.mktemp("shadow_tiny")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(run_shadow_scale, "make_cfg",
                   _tiny(run_shadow_scale.make_cfg))
        mp.setattr(shadow_segments, "make_cfg", _tiny(shadow_segments.make_cfg))
        mp.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp / "jax_cache"))
        cache = str(tmp / "data.npz")
        jwork, pwork = tmp / "jax", tmp / "port"
        jwork.mkdir()
        jargs = shadow_segments.parse_args(
            TINY_FLAGS + ["--workdir", str(jwork), "--data_cache", cache,
                          "--out", str(jwork / "rows.jsonl")])
        jpipe.ensure_data_cache(run_shadow_segments._cfg_for(
            jargs, distill_steps=0, distill_salt=0), 0, cache,
            log_fn=lambda m: None)
        for role, seg in (("ce", 0), ("distill", 0), ("distill", 1),
                          ("eval", 1)):
            run_shadow_segments.child(_with(jargs, child_role=role,
                                            child_segment=seg))

        labels = []

        def in_process(cmd, label, timeout):
            labels.append(label)
            shadow_segments.child(shadow_segments.parse_args(cmd[3:]))
            return True

        mp.setattr(segments, "run_child", in_process)
        argv = TINY_FLAGS + ["--workdir", str(pwork), "--data_cache", cache,
                             "--out", str(pwork / "rows.jsonl")]
        assert shadow_segments.main(argv) == 0
        first = list(labels)
        mtimes = {s: os.path.getmtime(segments.snapshot(str(pwork), "tiny", s))
                  for s in (-1, 0, 1)}
        labels.clear()
        assert shadow_segments.main(argv + ["--start_segment", "1"]) == 0
        return dict(
            pwork=pwork, labels=first, resume_labels=list(labels),
            mtimes=mtimes, cache=cache,
            jax_log=read_rows(str(jwork / "tiny_segments.jsonl")),
            jax_rows=read_rows(str(jwork / "rows.jsonl")),
            port_log=read_rows(str(pwork / "tiny_segments.jsonl")),
            port_rows=read_rows(str(pwork / "rows.jsonl")))
    finally:
        mp.undo()


def _with(ns, **kw):
    out = type(ns)(**vars(ns))
    for k, v in kw.items():
        setattr(out, k, v)
    return out


def test_shadow_segments_chain_and_resume(shadow_tiny):
    r = shadow_tiny
    assert r["labels"] == ["ce segment -1", "distill segment 0",
                           "distill segment 1", "eval segment 2"]
    assert r["resume_labels"] == ["distill segment 1", "eval segment 2"]
    pwork = str(r["pwork"])
    after = {s: os.path.getmtime(segments.snapshot(pwork, "tiny", s))
             for s in (-1, 0, 1)}
    assert after[-1] == r["mtimes"][-1] and after[0] == r["mtimes"][0]
    assert after[1] > r["mtimes"][1]
    log = r["port_log"]
    assert [s["segment"] for s in log] == [0, 1, 1]
    # Segment 1 starts where segment 0 ended, and again on resume.
    assert log[1]["ce_before"] == pytest.approx(log[0]["ce_after"], abs=1e-6)
    assert log[2]["ce_before"] == pytest.approx(log[0]["ce_after"], abs=1e-6)
    assert [row["tag"] for row in r["port_rows"]] == ["tiny_seg2x2"] * 2


def test_shadow_steps_log_and_row_match_the_script(shadow_tiny):
    r = shadow_tiny
    jlog, plog = r["jax_log"], r["port_log"][:2]
    assert [set(s) for s in plog] == [set(s) for s in jlog]
    assert [(s["segment"], s["steps_run"]) for s in plog] == [
        (s["segment"], s["steps_run"]) for s in jlog]
    (want,) = r["jax_rows"]
    got = r["port_rows"][0]
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    for k in ("tag", "epochs", "model", "distill_steps",
              "distill_steps_actual", "max_bases", "seed", "note"):
        assert got[k] == want[k], k
    # What depends on the data cache alone is the script's.
    for k in ("tv_shot_noise_floor", "meas_tv_to_target"):
        assert abs(got[k] - want[k]) <= DATA_TOL, k
    assert 0.0 <= got["mean_tv_to_target"] <= 1.0


@pytest.mark.parametrize("how", ["injected", "timeout"])
def test_shadow_segments_failing_child_ends_the_run(tmp_path, how):
    """A role that fails (``segments.FAIL_ENV``) or outlives
    ``--segment_timeout`` ends the driver with exit code 1: no retry, no
    later role, no row."""
    env = _port_env()
    extra = []
    if how == "injected":
        env[segments.FAIL_ENV] = "ce"
    else:
        extra = ["--segment_timeout", "1"]
    proc = subprocess.run(
        [sys.executable, "-m", "ddqst_tpu_torch.campaigns.shadow_segments",
         "--tag", "t", "--segments", "1", "--steps_per_segment", "1",
         "--device", "cpu", "--data_cache", "", "--workdir",
         str(tmp_path / "w"), "--out", str(tmp_path / "rows.jsonl"), *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert not (tmp_path / "rows.jsonl").exists()
    labels = [line.split("] ", 1)[1].rsplit(":", 1)[0]
              for line in proc.stdout.splitlines()
              if line.startswith("[segments]") and line.endswith("starting")]
    assert labels == ["ce segment -1"]
    assert ("injected failure in role 'ce'" if how == "injected"
            else "killed after 1 s (--segment_timeout)") in proc.stdout
    assert "resume with --start_segment -1" in proc.stdout
