"""The RQC-6 rung's committed seed-0 data and the split-rung parts of
``chip_smoke.py`` (``--scaling-part``) on the CPU.

(a) ``examples/reference_data/rqc6_auto_seed0.npz`` equals a fresh
``ddqst_tpu.pipeline.ensure_data_cache`` of ``scripts/run_scaling_ghz.py``'s
``rqc6_auto`` config at seed 0, array for array, and ``chip_smoke``'s copy
of that config is the script's; (b) the port reads the same counts from it
and its raw-inversion fidelity equals ``ddqst_tpu``'s within 1e-6 (and
``chip_smoke.SCALING_DATA_JAX``'s record); (c) MLE on the raw counts capped
at 20 iterations gives ρ within 2e-4 of ``ddqst_tpu``'s, in as many
iterations; (d) at a tiny config (N = 3, width 16, T = 4, 2 epochs) a CE
stopped after epoch 1 and resumed in a second part gives the parameters,
losses and metrics of one uninterrupted ``run_experiment`` bit for bit, and
a GHZ-7-shaped split (CE halves, two chained distillation parts on a shared
MLE target, an eval part) runs through its files, and GHZ-6's and RQC-5's
held-out splits (the distillation and eval in a part of their own) give
one run's parameters, losses, held-out history and metrics bit for bit;
(e) a part whose inputs are missing raises before any work; (f) the splits
cover the recipes; (g) the split rung's row and the ``--no-stop``
diagnostic; (h) the ``--draws`` and ``--salt`` diagnostics: a draw file that
does not fit the part is refused before any work, the rows are the
minibatches the part takes, one a step, and ``--salt K`` runs the part at
``chain_key_salt`` + K; (i) ``--matmul-precision``: refused off an uncut
distilling part and for an unknown name, and at ``bfloat16`` the part's
distillation, held-out CE and tables run through ``ops.precision``'s
bf16-pass products (counting stand-ins) and the record says so; (j) every
part records the sha256 of the parameters it starts from and leaves, each
part's input its predecessor's output (or the hash of the file it was
really handed), the eval record the step kernel's timing fields, and
``--row-note`` only on an uncut evaluating part; (k) ``--seed K``: a seed-1
split gives one ``run_experiment(cfg, seed=1)`` bit for bit (and CE losses
unlike seed 0's), the flag is taken by any uncut part and refused with
``--cut``, the record, its file name and the row's note name the seed, and
a part refuses a predecessor's record of another seed or output hash.
"""

import dataclasses
import importlib.util
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ddqst_tpu import pipeline as jpipe
from ddqst_tpu.ops import mle as jmle
from ddqst_tpu.ops.complexlib import to_complex
from ddqst_tpu_torch import pipeline as tpipe
from ddqst_tpu_torch.campaigns.recipes import auto_recipe, quality_cfg
from ddqst_tpu_torch.ops import cuda_kernels as ck
from ddqst_tpu_torch.ops import metrics as tM
from ddqst_tpu_torch.ops import mle as tmle
from ddqst_tpu_torch.ops import pauli as tpauli
from ddqst_tpu_torch.ops import precision

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, chip_smoke.SCALING_DATA["rqc6_auto"])
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


@pytest.fixture(scope="module")
def rqc6(tmp_path_factory):
    """The JAX config, a fresh JAX cache at seed 0, the committed file as
    each package reads it."""
    tool = _tool()
    cfg = tool.rung_cfg("rqc6_auto")
    fresh = str(tmp_path_factory.mktemp("rqc6") / "fresh.npz")
    jpipe.ensure_data_cache(cfg, 0, fresh, log_fn=lambda m: None)
    return dict(tool=tool, cfg=cfg, fresh=fresh,
                jax=jpipe.load_data_cache(DATA),
                port=tpipe.load_data_cache(DATA, "cpu"))


def test_committed_data_is_a_fresh_jax_cache(rqc6):
    with np.load(DATA) as got, np.load(rqc6["fresh"]) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["bits"].shape == (3**6, 5000, 6)


def test_chip_smoke_rung_is_the_scripts(rqc6):
    """``chip_smoke.scaling_rung('rqc6_auto')`` is
    ``scripts/run_scaling_ghz.py``'s config, field for field."""
    want = dataclasses.asdict(rqc6["cfg"])
    got = dataclasses.asdict(chip_smoke.scaling_rung("rqc6_auto"))
    for section in ("model", "diffusion", "train", "data"):
        common = set(want[section]) & set(got[section])
        assert {k: got[section][k] for k in common} == {
            k: want[section][k] for k in common}, section
    assert got["name"] == want["name"]


def test_port_reads_the_same_counts_and_raw_inversion(rqc6):
    jd, td = rqc6["jax"], rqc6["port"]
    np.testing.assert_array_equal(
        tmle.bits_to_counts(td.bits).numpy(),
        np.asarray(jmle.bits_to_counts(jd.bits)))
    np.testing.assert_array_equal(td.basis_labels, jd.basis_labels)
    want = rqc6["tool"].data_side(rqc6["cfg"], jd, mle_iterations=1)
    raw = tmle.bits_to_counts(td.bits)
    rho = tpauli.make_counts_inverter(6, td.basis_labels)(raw)
    got = float(tM.state_fidelity(torch.from_numpy(td.target), rho))
    assert abs(got - want["raw_fidelity"]) <= RAW_ATOL
    rec = chip_smoke.SCALING_DATA_JAX["rqc6_auto"]
    assert abs(want["raw_fidelity"] - rec["raw_fidelity"]) <= RAW_ATOL


def test_mle_on_raw_capped_matches_jax(rqc6):
    jd, td = rqc6["jax"], rqc6["port"]
    with rqc6["tool"].CountedSolve() as solve:
        want = jmle.make_mle(6, jd.basis_labels, readout_p=0.01,
                             iterations=MLE_ITERS)(
            jmle.bits_to_counts(jd.bits).astype(jnp.float32))
    info: dict = {}
    got = tmle.make_mle(6, td.basis_labels, readout_p=0.01,
                        iterations=MLE_ITERS)(tmle.bits_to_counts(td.bits),
                                              info)
    assert info["iterations"] == solve.iterations[0] == MLE_ITERS
    np.testing.assert_allclose(got.numpy(), np.asarray(to_complex(want)),
                               atol=RHO_ATOL)


def _tiny(target: str = "counts", val_fraction: float = 0.15):
    """The RQC-6 recipe's stack at N = 3, width 16, T = 4, 2 epochs."""
    cfg = auto_recipe(
        quality_cfg("tiny", num_qubits=3, state="rqc",
                    shots_train=200, shots_infer=300),
        epochs=2, steps=2, steps_per_call=1, target=target,
        val_fraction=val_fraction)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, embed_dim=16, hidden_dim=16,
                                  num_blocks=1),
        diffusion=dataclasses.replace(cfg.diffusion, num_timesteps=4))


TINY_SPLIT = {"ce1": dict(ce=(0, 1), every=1),
              "ce2": dict(ce=(1, 2), every=1, steps=2, eval=True)}


def _part(tmp, part, parts, cfg, data, **kw):
    with chip_smoke._MleCapped(30):
        return chip_smoke.scaling_part(ck, "tiny", part, str(tmp), str(tmp),
                                       cfg=cfg, parts=parts, data=data,
                                       device="cpu", **kw)


def test_split_ce_equals_one_run(tmp_path):
    cfg = _tiny()
    data = tpipe.ensure_data_cache(cfg, 0, str(tmp_path / "data.npz"),
                                   log_fn=lambda m: None, device="cpu")
    with chip_smoke._MleCapped(30):
        want = tpipe.run_experiment(cfg, seed=0, device="cpu",
                                    data_cache=data, log_fn=lambda m: None)
    work = tmp_path / "work"
    out1, res1, _ = _part(work, "ce1", TINY_SPLIT, cfg, data)
    assert res1 == {"ce_stopped_at": 1} and out1["ce_epochs"] == [0, 1]
    assert sorted(os.listdir(work / "tiny_ckpt")) == ["1"]
    out2, got, _ = _part(work, "ce2", TINY_SPLIT, cfg, data)
    assert sorted(os.listdir(work / "tiny_ckpt")) == ["1"]
    assert got["train_steps"] == want["train_steps"] // 2
    np.testing.assert_array_equal(got["losses"], want["losses"][1:])
    for (k, p), q in zip(got["state"].state_dict().items(),
                         want["state"].state_dict().values()):
        assert torch.equal(p, q), k
    np.testing.assert_array_equal(got["ft_losses"], want["ft_losses"])
    for k in ("fidelity", "raw_fidelity", "raw_fidelity_mitigated",
              "trace_distance"):
        assert got[k] == want[k], k
    assert out2["best_step"] == want["chain_info"]["best_step"]
    assert torch.equal(got["samples"], want["samples"])


# The ladder's held-out splits at the tiny config: GHZ-6's and RQC-5's (CE
# halves, then the distillation and eval in a part of its own) and RQC-6's
# (the second CE half distils and evaluates), the distillation holding out
# 15% of the shots.
HELD_OUT_SPLITS = {
    "ghz6": {"ce1": dict(ce=(0, 1), every=1), "ce2": dict(ce=(1, 2), every=1),
             "d": dict(steps=6, eval=True)},
    "rqc6": {"ce1": dict(ce=(0, 1), every=1),
             "ce2": dict(ce=(1, 2), every=1, steps=6, eval=True)},
}


@pytest.mark.parametrize("shape", list(HELD_OUT_SPLITS))
def test_split_held_out_distillation_equals_one_run(tmp_path, shape):
    """The CE parts train on every shot, the last part holds out the same
    shots as one uninterrupted ``run_experiment``: the parameters, CE and
    distillation losses, ``best_step``, ``val_history`` and metrics equal
    that run's bit for bit."""
    parts = HELD_OUT_SPLITS[shape]
    cfg = _tiny()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                chain_finetune_steps=6))
    assert cfg.train.chain_val_fraction == 0.15
    data = tpipe.ensure_data_cache(cfg, 0, str(tmp_path / "data.npz"),
                                   log_fn=lambda m: None, device="cpu")
    with chip_smoke._MleCapped(30):
        want = tpipe.run_experiment(cfg, seed=0, device="cpu",
                                    data_cache=data, log_fn=lambda m: None)
    info = want["chain_info"]
    assert len(info["val_history"]) > 2
    work = tmp_path / "work"
    ce_losses = []
    for part in parts:
        out, got, _ = _part(work, part, parts, cfg, data)
        if "losses" in got:
            ce_losses.append(np.asarray(got["losses"]))
    # A part stopped on its checkpoint returns no losses: ce2 has epoch 2's.
    ce_losses = np.concatenate(ce_losses)
    assert len(ce_losses) == 1
    np.testing.assert_array_equal(
        ce_losses, np.asarray(want["losses"])[-len(ce_losses):])
    for (k, p), q in zip(got["state"].state_dict().items(),
                         want["state"].state_dict().values()):
        assert torch.equal(p, q), k
    np.testing.assert_array_equal(got["ft_losses"], want["ft_losses"])
    assert out["best_step"] == info["best_step"]
    assert out["val_history"] == [[k, ce] for k, ce in info["val_history"]]
    assert out["best_val_ce"] == info["best_val_ce"]
    assert out["distill_steps_run"] == len(want["ft_losses"])
    for k in ("fidelity", "raw_fidelity", "raw_fidelity_mitigated",
              "trace_distance"):
        assert got[k] == want[k], k
    assert torch.equal(got["samples"], want["samples"])


GHZ7_SHAPED = {"ce1": dict(ce=(0, 1), every=1),
               "ce2": dict(ce=(1, 2), every=1),
               "d1": dict(steps=1), "d2": dict(steps=2),
               "eval": dict(eval=True)}


@pytest.fixture(scope="module")
def ghz7_split(tmp_path_factory):
    """The GHZ-7-shaped split at the tiny config, every part in order in one
    folder: its folder, the config and each part's record and result."""
    tmp = tmp_path_factory.mktemp("ghz7_split")
    cfg = _tiny(target="mle", val_fraction=0.0)
    outs, results = {}, {}
    for part in GHZ7_SHAPED:
        outs[part], results[part], _ = _part(tmp, part, GHZ7_SHAPED, cfg,
                                             None)
    return dict(dir=tmp, cfg=cfg, outs=outs, res=results)


def test_ghz7_shaped_split_chains_its_files(ghz7_split):
    """CE halves, two distillation parts chained by their parameters, Adam
    state (``chain_key_salt`` + k) and one MLE target cache, then the eval
    part; the data written by the first part and read by the rest."""
    tmp_path, outs = ghz7_split["dir"], ghz7_split["outs"]
    res = ghz7_split["res"]["eval"]
    files = set(os.listdir(tmp_path))
    assert {"tiny_data.npz", "tiny_target.npz", "tiny_ce2_params.pt",
            "tiny_d1_params.pt", "tiny_d1_opt.pt", "tiny_d2_params.pt",
            "tiny_d2_opt.pt"} <= files
    assert outs["d1"]["distill_steps_run"] == 1
    assert outs["d2"]["distill_steps_run"] == 2
    for part in ("d1", "d2"):  # the stages from the part's log
        rec = outs[part]
        assert rec["target_s"] > 0 and rec["distill_s"] > 0
        assert rec["distill_s_per_step"] == (
            rec["distill_s"] / rec["distill_steps_run"])
        assert rec["target_s"] + rec["distill_s"] < rec["wall_s"]
    assert torch.load(tmp_path / "tiny_d2_opt.pt",
                      weights_only=True)["count"] == 3
    assert abs(outs["d2"]["ce_before"] - outs["d1"]["ce_after"]) <= (
        1e-5 * outs["d1"]["ce_after"])
    assert "chain_info" not in res and np.isfinite(res["fidelity"])


def test_each_part_starts_from_its_predecessors_parameters(ghz7_split):
    """Every part's ``params_in_sha256`` is its predecessor's
    ``params_out_sha256``: ce1's checkpoint, then each parameter file; ce1
    starts fresh and the eval part writes none."""
    outs, names = ghz7_split["outs"], list(GHZ7_SHAPED)
    assert outs["ce1"]["params_in_sha256"] is None
    assert outs["eval"]["params_out_sha256"] is None
    for prev, part in zip(names, names[1:]):
        assert outs[part]["params_in_sha256"] == (
            outs[prev]["params_out_sha256"]), part
        assert len(outs[part]["params_in_sha256"]) == 64


def test_d1_starts_from_ce2s_parameter_file(ghz7_split):
    """d1's input hash is ce2's output hash and the hash of the file ce2
    left, as ``sha256sum`` gives it."""
    import hashlib

    outs = ghz7_split["outs"]
    with open(ghz7_split["dir"] / "tiny_ce2_params.pt", "rb") as f:
        want = hashlib.sha256(f.read()).hexdigest()
    assert outs["d1"]["params_in_sha256"] == outs["ce2"][
        "params_out_sha256"] == want
    assert chip_smoke.file_sha256(
        str(ghz7_split["dir"] / "tiny_d1_params.pt")) == outs["d1"][
            "params_out_sha256"]


def test_a_part_records_the_hash_of_the_parameters_it_was_handed(
        ghz7_split, tmp_path):
    """A d1 handed another parameter file (d2's, under ce2's name) records
    that file's hash, not ce2's, so a row cannot claim a CE model it did
    not start from."""
    for name in ("tiny_data.npz", "tiny_target.npz"):
        shutil.copy(ghz7_split["dir"] / name, tmp_path / name)
    shutil.copy(ghz7_split["dir"] / "tiny_d2_params.pt",
                tmp_path / "tiny_ce2_params.pt")
    got, _, _ = _part(tmp_path, "d1", GHZ7_SHAPED, ghz7_split["cfg"], None)
    outs = ghz7_split["outs"]
    assert got["params_in_sha256"] == outs["d2"]["params_out_sha256"]
    assert got["params_in_sha256"] != outs["ce2"]["params_out_sha256"]


def test_eval_record_carries_the_step_timing_fields(ghz7_split):
    """The eval part's record has the step kernel's timing fields: on the
    CPU no launch, so 0 timed launches and no times; the generation stage's
    host seconds beside them. A part that does not generate has none."""
    ev, d1 = ghz7_split["outs"]["eval"], ghz7_split["outs"]["d1"]
    assert (ev["step_launches"], ev["step_timed_launches"]) == (0, 0)
    assert ev["step_ms_mean"] is None and ev["step_ms_total"] is None
    tm = ghz7_split["res"]["eval"]["timings"]
    assert ev["generation_s"] == tm["tables"] + tm["walk"] > 0
    assert d1["generation_s"] is None and d1["step_timed_launches"] == 0


@pytest.mark.parametrize("tag,part,cut,ok", [
    ("ghz7_mle_hot", "eval", False, True),
    ("ghz7_mle_hot", "d3", False, False),
    ("rqc6_auto", "ce2", True, False)])
def test_row_note_takes_an_uncut_evaluating_part(tmp_path, tag, part, cut,
                                                 ok):
    """``--row-note`` reaches the arguments of GHZ-7's eval part and is
    refused on a distilling part and on a cut run, before any work."""
    parts = (chip_smoke.SCALING_CUT_PARTS if cut
             else chip_smoke.SCALING_PARTS)[tag]
    plan = chip_smoke.part_files(tag, {k: dict(p, total=0) for k, p in
                                       parts.items()}, part, str(tmp_path),
                                 str(tmp_path / "o"), mle_target=True)
    for need in plan["needs"]:  # the inputs, empty: nothing reads them
        os.makedirs(os.path.dirname(need), exist_ok=True)
        if not os.path.exists(need):
            open(need, "wb").close()
    argv = ([tag, part, str(tmp_path), str(tmp_path / "o"), "--row-note",
             "CE halves shared the card"] + (["--cut"] if cut else []))
    if not ok:
        with pytest.raises(ValueError, match="--row-note"):
            chip_smoke.scaling_part_args(argv)
        return
    got = chip_smoke.scaling_part_args(argv)
    assert got["row_note"] == "CE halves shared the card"
    assert chip_smoke.scaling_part_args(argv[:4])["row_note"] is None


@pytest.mark.parametrize("part", ["ce2", "d1"])
def test_part_with_missing_inputs_refuses_before_work(tmp_path, part):
    parts = {"ce1": dict(ce=(0, 1), every=1), "ce2": dict(ce=(1, 2), every=1),
             "d1": dict(steps=1)}
    ck.fused_chain_walk.launches = 7
    out = tmp_path / "out"
    with pytest.raises(FileNotFoundError, match="missing"):
        chip_smoke.scaling_part(ck, "tiny", part, str(tmp_path / "in"),
                                str(out), cfg=_tiny(), parts=parts,
                                data=str(tmp_path / "data.npz"),
                                device="cpu")
    assert not out.exists() and ck.fused_chain_walk.launches == 7


def test_committed_rung_refuses_without_its_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="rqc6_auto_ckpt"):
        chip_smoke.part_setup("rqc6_auto", "ce2", str(tmp_path),
                              str(tmp_path), cut=False)
    # ce1 needs only the committed file.
    chip_smoke.part_setup("rqc6_auto", "ce1", str(tmp_path), str(tmp_path),
                          cut=False)


@pytest.mark.parametrize("tag,cut,epochs,steps", [
    ("rqc6_auto", False, 150, 800), ("ghz7_mle_hot", False, 60, 1600),
    ("rqc6_auto", True, 2, 10), ("rqc5_auto", False, 300, 800),
    ("ghz6_auto", False, 150, 800)])
def test_splits_cover_the_recipe(tag, cut, epochs, steps):
    parts = (chip_smoke.SCALING_CUT_PARTS if cut
             else chip_smoke.SCALING_PARTS)[tag]
    cfg = chip_smoke.scaling_rung(tag)
    ces = [p["ce"] for p in parts.values() if "ce" in p]
    assert ces[0][0] == 0 and all(a[1] == b[0] for a, b in zip(ces, ces[1:]))
    assert ces[-1][1] == epochs
    if not cut:
        assert epochs == cfg.train.num_epochs
        assert steps == cfg.train.chain_finetune_steps
    assert sum(p.get("steps", 0) for p in parts.values()) == steps
    assert [k for k, p in parts.items() if p.get("eval")] == [list(parts)[-1]]
    for part in parts:  # every part's files resolve
        chip_smoke.part_files(tag, {k: dict(p, total=epochs)
                                    for k, p in parts.items()}, part, "i",
                              "o", mle_target=cfg.train.chain_target == "mle")


def test_committed_ghz6_ce_parameters_start_its_distilling_part(tmp_path):
    """GHZ-6's CE parameters from the card's uncut run (epochs 1-150,
    ``examples/reference_params/ghz6_auto_ce2_params.pt``) load strictly
    into the recipe's model, finite, and part ``d`` needs nothing else."""
    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.utils.checkpoint import restore_params

    path = os.path.join(os.path.dirname(chip_smoke.__file__), "examples",
                        "reference_params", "ghz6_auto_ce2_params.pt")
    cfg = chip_smoke.scaling_rung("ghz6_auto")
    model = restore_params(path, build_model(
        cfg.model, 6, cfg.diffusion.num_timesteps))
    assert all(bool(p.isfinite().all()) for p in model.parameters())
    shutil.copy(path, tmp_path / "ghz6_auto_ce2_params.pt")
    _, _, plan = chip_smoke.part_setup("ghz6_auto", "d", str(tmp_path),
                                       str(tmp_path), cut=False)
    assert plan["kw"]["params_load"] == str(tmp_path /
                                            "ghz6_auto_ce2_params.pt")
    assert "opt_load" not in plan["kw"] and plan["salt"] == 0


def test_cut_split_runs_the_cut_epochs(tmp_path):
    """The default run's cut trains 2 CE epochs in all (the cosine
    schedule's length), and its first part needs only the committed data."""
    cfg, parts, plan = chip_smoke.part_setup("rqc6_auto", "ce1",
                                             str(tmp_path), str(tmp_path),
                                             cut=True)
    assert cfg.train.num_epochs == 2 and plan["stop"] == 1
    assert cfg.train.chain_finetune_steps == 800  # each part sets its own
    with pytest.raises(FileNotFoundError, match="rqc6_auto_ckpt"):
        chip_smoke.part_setup("rqc6_auto", "ce2", str(tmp_path),
                              str(tmp_path), cut=True)


def test_a_stop_off_its_checkpoint_is_refused():
    with pytest.raises(ValueError, match="not on a checkpoint"):
        chip_smoke.part_files("x", {"ce1": dict(ce=(0, 3), every=2, total=4)},
                              "ce1", "i", "o")
    with pytest.raises(ValueError, match="neither distils"):
        chip_smoke.part_files("x", {"ce1": dict(ce=(0, 2), every=2, total=4,
                                                steps=3)}, "ce1", "i", "o")


GHZ6_DRAWS = os.path.join(ROOT, "examples", "reference_data",
                          "ghz6_auto_draws_seed0.npz")
GHZ6_CE = os.path.join(ROOT, "examples", "reference_params",
                       "ghz6_auto_ce2_params.pt")


@pytest.mark.parametrize("bad,match", [
    ("short", r"\[>= 800, 96\]"), ("tag", "drawn for tag"),
    ("file_salt", "drawn for salt"), ("part_salt", "drawn for salt"),
    ("cut", "uncut distilling part"), ("ce_part", "uncut distilling part")])
def test_draws_that_do_not_fit_the_part_are_refused(tmp_path, bad, match):
    """``--draws`` on GHZ-6's ``d`` refuses, before any work, a file with
    one row too few, one drawn for another rung or salt, the committed
    salt-0 file under ``--salt 1``, and any diagnostic on a cut or CE
    part; the committed file itself fits."""
    shutil.copy(GHZ6_CE, tmp_path / "ghz6_auto_ce2_params.pt")
    with np.load(GHZ6_DRAWS) as f:
        rows, meta = f["draws"], {k: f[k] for k in f.files if k != "draws"}
    if bad == "short":
        rows = rows[:-1]
    elif bad == "tag":
        meta["tag"] = np.array("rqc6_auto")
    elif bad == "file_salt":
        meta["salt"] = np.int64(1)
    path = tmp_path / "draws.npz"
    np.savez(path, draws=rows, **meta)
    out = tmp_path / "out"
    argv = ["ghz6_auto", "d", str(tmp_path), str(out), "--draws", str(path)]
    if bad == "part_salt":
        argv += ["--salt", "1"]
    elif bad == "cut":
        argv = ["rqc6_auto", "ce1", str(tmp_path), str(out), "--cut",
                "--salt", "1"]
    elif bad == "ce_part":
        argv = ["ghz6_auto", "ce1", str(tmp_path), str(out), "--salt", "1"]
    ck.fused_chain_walk.launches = 7
    with pytest.raises(ValueError, match=match):
        chip_smoke.scaling_part_args(argv)
    assert not out.exists() and ck.fused_chain_walk.launches == 7
    a = chip_smoke.scaling_part_args(
        ["ghz6_auto", "d", str(tmp_path), str(out), "--draws", GHZ6_DRAWS,
         "--no-stop", "300"])
    assert a["draws"][1] == "jax_seed0" and a["draws"][0].shape == (800, 96)
    assert a["parts"]["d"]["steps"] == 300 and a["salt"] == 0


def _minibatched():
    """The tiny stack with a minibatch of 8 of the 27 bases a step, so the
    draw stream decides the distillation."""
    cfg = _tiny()
    return cfg.replace(train=dataclasses.replace(
        cfg.train, chain_finetune_steps=6, chain_basis_batch=8))


def _tiny_draws(tmp_path):
    cfg, parts = _minibatched(), HELD_OUT_SPLITS["ghz6"]
    data = tpipe.ensure_data_cache(cfg, 0, str(tmp_path / "data.npz"),
                                   log_fn=lambda m: None, device="cpu")
    _part(tmp_path, "ce1", parts, cfg, data)
    _part(tmp_path, "ce2", parts, cfg, data)
    return cfg, parts, data


def test_draws_are_the_minibatches_one_row_a_step(tmp_path):
    """The rows the port's own stream draws, written as a draw file and
    handed back through ``--draws``, give that run's distillation bit for
    bit; the record names the file's stream, counts one row a step and
    keeps the first losses."""
    cfg, parts, data = _tiny_draws(tmp_path)
    own, seen = torch.multinomial, []

    def spy(*args, **kw):
        seen.append(own(*args, **kw))
        return seen[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "multinomial", spy)
        want, wres, _ = _part(tmp_path, "d", parts, cfg, data)
    assert len(seen) == want["distill_steps_run"] > 0
    path = tmp_path / "draws.npz"
    np.savez(path, draws=torch.stack(seen).numpy().astype(np.int16),
             tag=np.array("tiny"), seed=np.int64(0), salt=np.int64(0),
             steps_per_call=np.int64(cfg.train.chain_steps_per_call))
    draws = chip_smoke.load_draws(str(path), "tiny", cfg, len(seen), 0)
    with pytest.raises(ValueError, match="the part needs"):
        chip_smoke.load_draws(str(path), "tiny", cfg, len(seen) + 1, 0)
    got, gres, _ = _part(tmp_path, "d", parts, cfg, data, draws=draws)
    np.testing.assert_array_equal(gres["ft_losses"], wres["ft_losses"])
    assert got["val_history"] == want["val_history"]
    assert got["distill_steps_run"] == len(seen)
    assert got["draws"] == "jax_seed0" and got["draw_rows_used"] == len(seen)
    assert got["first_losses"] == [float(v) for v in gres["ft_losses"]]
    assert gres["fidelity"] == wres["fidelity"]


def test_salt_moves_the_parts_chain_key_salt(tmp_path):
    """``--salt 2`` runs the part as the recipe at ``chain_key_salt`` + 2
    would, which draws other bases than salt 0, and records both."""
    cfg, parts, data = _tiny_draws(tmp_path)
    base, _, _ = _part(tmp_path, "d", parts, cfg, data)
    got, gres, _ = _part(tmp_path, "d", parts, cfg, data, salt=2)
    assert (got["chain_key_salt"], got["salt_offset"]) == (
        cfg.train.chain_key_salt + 2, 2)
    assert base["chain_key_salt"] == cfg.train.chain_key_salt
    moved = cfg.replace(train=dataclasses.replace(
        cfg.train, chain_key_salt=cfg.train.chain_key_salt + 2))
    _, wres, _ = _part(tmp_path, "d", parts, moved, data)
    np.testing.assert_array_equal(gres["ft_losses"], wres["ft_losses"])
    assert base["val_history"] != got["val_history"]


def test_split_row_sums_the_parts(tmp_path):
    """The evaluating part's row: ``campaigns.scaling``'s keys, the rung's
    note, ``wall_s`` the sum of the parts' records found in ``IN_DIR``."""
    for part, wall in (("ce1", 100.0), ("ce2", 200.25)):
        with open(tmp_path / f"ghz6_auto_{part}.json", "w") as f:
            json.dump(dict(wall_s=wall), f)
    res = dict(fidelity=0.978451, raw_fidelity=0.754449,
               raw_fidelity_mitigated=0.999956, trace_distance=0.025201)
    cfg = chip_smoke.scaling_rung("ghz6_auto")
    row, walls = chip_smoke.split_row("ghz6_auto", cfg, res, str(tmp_path),
                                      ["ce1", "ce2", "d"], 50.0, "card")
    assert walls == {"ce1": 100.0, "ce2": 200.25, "d": 50.0}
    assert row == dict(
        tag="ghz6_auto", num_qubits=6, fidelity=0.97845, raw_fidelity=0.75445,
        raw_fidelity_mitigated=0.99996, trace_distance=0.0252,
        note="GHZ-6, automated distillation recipe (96-basis minibatch)",
        wall_s=350.2, device="card")
    assert set(row) == chip_smoke.CAMPAIGN_ROW_KEYS
    os.remove(tmp_path / "ghz6_auto_ce1.json")
    _, walls = chip_smoke.split_row("ghz6_auto", cfg, res, str(tmp_path),
                                    ["ce1", "ce2", "d"], 50.0, "card")
    assert walls == {"ce2": 200.25, "d": 50.0}


def test_no_stop_runs_every_step_and_keeps_the_best(tmp_path):
    """``--no-stop K`` (a diagnostic): K distillation steps, the held-out
    patience past them, every evaluation in the history; the recipe and
    the split themselves unchanged."""
    parts = HELD_OUT_SPLITS["ghz6"]
    cfg = _tiny()
    dcfg, dparts = chip_smoke.no_stop(cfg, parts, "d", 8)
    assert (dcfg.train.chain_finetune_steps, dcfg.train.chain_val_patience,
            dparts["d"]["steps"]) == (8, 9, 8)
    assert parts["d"]["steps"] == 6 and cfg.train.chain_val_patience == 4
    with pytest.raises(ValueError, match="does not distil"):
        chip_smoke.no_stop(cfg, parts, "ce2", 8)
    data = tpipe.ensure_data_cache(cfg, 0, str(tmp_path / "data.npz"),
                                   log_fn=lambda m: None, device="cpu")
    _part(tmp_path, "ce1", parts, cfg, data)
    _part(tmp_path, "ce2", parts, cfg, data)
    out, res, _ = _part(tmp_path, "d", dparts, dcfg, data)
    assert out["distill_steps_run"] == 8
    steps = [k for k, _ in out["val_history"]]
    assert steps[0] == 0 and steps[-1] == 8 and steps == sorted(steps)
    assert out["best_val_ce"] == min(ce for _, ce in out["val_history"])
    assert np.isfinite(res["fidelity"])


@pytest.mark.parametrize("argv,match", [
    (["ghz6_auto", "ce1", "--matmul-precision", "bfloat16"],
     "uncut distilling part"),
    (["ghz6_auto", "ce2", "--matmul-precision", "float32"],
     "uncut distilling part"),
    (["rqc6_auto", "ce2", "--cut", "--matmul-precision", "bfloat16"],
     "uncut distilling part"),
    (["ghz6_auto", "d", "--matmul-precision", "float16"],
     "unknown matmul precision"),
    (["ghz6_auto", "d", "--matmul-precision"], "needs a value")])
def test_matmul_precision_off_a_distilling_part_is_refused(tmp_path, argv,
                                                           match):
    """``--matmul-precision`` on a CE part, a cut part, with an unknown
    name or no name raises before any work; on GHZ-6's ``d`` from the
    committed CE parameters it is taken, beside a salt."""
    inp, out = tmp_path / "in", tmp_path / "out"
    os.makedirs(inp)
    shutil.copy(GHZ6_CE, inp / "ghz6_auto_ce2_params.pt")
    # The CE parts' checkpoints, present so only the flag is refused.
    for ckpt in ("ghz6_auto_ckpt/75", "rqc6_auto_ckpt/1"):
        os.makedirs(inp / ckpt)
        open(inp / ckpt / "checkpoint.pt", "w").close()
    full = argv[:2] + [str(inp), str(out)] + argv[2:]
    with pytest.raises(ValueError, match=match):
        chip_smoke.scaling_part_args(full)
    assert not out.exists()
    a = chip_smoke.scaling_part_args(
        ["ghz6_auto", "d", str(inp), str(out), "--matmul-precision",
         "bfloat16", "--salt", "2"])
    assert (a["matmul_precision"], a["salt"]) == ("bfloat16", 2)
    a = chip_smoke.scaling_part_args(["ghz6_auto", "d", str(inp), str(out)])
    assert a["matmul_precision"] == "float32"


def test_matmul_precision_reaches_the_parts_distillation(tmp_path,
                                                         monkeypatch):
    """At the tiny stack the ``d`` part within the ``bfloat16`` context (as
    ``--matmul-precision`` runs it) takes its distillation steps, held-out
    CE and generation tables through the bf16-pass products (counted by
    stand-ins that call through) and records the precision; at float32
    nothing reaches them, and the two parts' losses differ."""
    cfg, parts, data = _tiny_draws(tmp_path)
    calls = {"linear": 0, "chain_product": 0}

    def counted(name):
        own = getattr(precision, name)

        def stand_in(*a):
            calls[name] += 1
            return own(*a)
        return stand_in

    for name in calls:
        monkeypatch.setattr(precision, name, counted(name))
    base, bres, _ = _part(tmp_path, "d", parts, cfg, data)
    assert calls == {"linear": 0, "chain_product": 0}
    assert base["matmul_precision"] == "float32"
    with precision.default_matmul_precision("bfloat16"):
        got, gres, _ = _part(tmp_path, "d", parts, cfg, data)
    assert precision.current() == "float32"
    assert got["matmul_precision"] == "bfloat16"
    t_steps = cfg.diffusion.num_timesteps
    # Every distillation step and held-out evaluation runs T chain products
    # (the backward recomputes them once more under the checkpoint).
    assert calls["chain_product"] >= t_steps * (
        got["distill_steps_run"] + len(got["val_history"]))
    assert calls["linear"] > calls["chain_product"]
    assert got["distill_steps_run"] == base["distill_steps_run"]
    assert not np.array_equal(gres["ft_losses"], bres["ft_losses"])
    assert np.isfinite(gres["fidelity"])


def test_seed_split_equals_one_run_at_that_seed(tmp_path):
    """``seed=1`` through GHZ-6's held-out split (``ce1`` stopped on its
    checkpoint, ``ce2`` resumed from it, then ``d``) gives one
    ``run_experiment(cfg, seed=1)`` on the same data file bit for bit: its
    CE losses, parameters, distillation losses, held-out history and
    metrics; and the CE losses are not seed 0's. Every record says
    ``seed: 1`` and each part's input hash is its predecessor's output."""
    parts = HELD_OUT_SPLITS["ghz6"]
    cfg = _tiny()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                chain_finetune_steps=6))
    data = tpipe.ensure_data_cache(cfg, 0, str(tmp_path / "data.npz"),
                                   log_fn=lambda m: None, device="cpu")
    with chip_smoke._MleCapped(30):
        want = tpipe.run_experiment(cfg, seed=1, device="cpu",
                                    data_cache=data, log_fn=lambda m: None)
        seed0 = tpipe.run_experiment(cfg, seed=0, device="cpu",
                                     data_cache=data, log_fn=lambda m: None)
    work = tmp_path / "work"
    outs, ce_losses = {}, []
    for part in parts:
        outs[part], got, _ = _part(work, part, parts, cfg, data, seed=1)
        if "losses" in got:
            ce_losses.append(np.asarray(got["losses"]))
        with open(work / chip_smoke.part_record_name("tiny", part, 1),
                  "w") as f:
            json.dump(outs[part], f)
    assert [o["seed"] for o in outs.values()] == [1, 1, 1]
    for prev, part in zip(parts, list(parts)[1:]):
        assert outs[part]["params_in_sha256"] == (
            outs[prev]["params_out_sha256"]), part
    np.testing.assert_array_equal(np.concatenate(ce_losses),
                                  np.asarray(want["losses"])[-1:])
    assert not np.array_equal(want["losses"], seed0["losses"])
    for (k, p), q in zip(got["state"].state_dict().items(),
                         want["state"].state_dict().values()):
        assert torch.equal(p, q), k
    np.testing.assert_array_equal(got["ft_losses"], want["ft_losses"])
    info = want["chain_info"]
    assert outs["d"]["best_step"] == info["best_step"]
    assert outs["d"]["val_history"] == [[k, ce] for k, ce in
                                        info["val_history"]]
    for k in ("fidelity", "raw_fidelity", "trace_distance"):
        assert got[k] == want[k], k
    assert torch.equal(got["samples"], want["samples"])


def _ghz6_in(tmp_path):
    """GHZ-6's ``IN_DIR`` with the committed CE parameters and empty CE
    checkpoints, so that only the flags decide."""
    inp = tmp_path / "in"
    os.makedirs(inp / "ghz6_auto_ckpt" / "75")
    open(inp / "ghz6_auto_ckpt" / "75" / "checkpoint.pt", "w").close()
    shutil.copy(GHZ6_CE, inp / "ghz6_auto_ce2_params.pt")
    os.makedirs(inp / "rqc6_auto_ckpt" / "1")
    open(inp / "rqc6_auto_ckpt" / "1" / "checkpoint.pt", "w").close()
    return inp


@pytest.mark.parametrize("argv,seed", [
    (["ghz6_auto", "ce1", "--seed", "1"], 1),
    (["ghz6_auto", "ce2", "--seed", "1"], 1),
    (["ghz6_auto", "d", "--seed", "1", "--salt", "3"], 1),
    (["ghz6_auto", "d", "--seed", "0"], 0),
    (["ghz6_auto", "d"], 0),
    (["rqc6_auto", "ce1", "--cut", "--seed", "1"], "--cut"),
    (["rqc6_auto", "ce2", "--seed", "0", "--cut"], "--cut"),
    (["ghz6_auto", "d", "--seed", "-1"], "0 or more"),
    (["ghz6_auto", "d", "--seed", "one"], "0 or more"),
    (["ghz6_auto", "ce1", "--seed"], "needs a value")])
def test_seed_is_taken_by_any_uncut_part_and_refused_with_cut(
        tmp_path, argv, seed):
    """``--seed K`` reaches a CE part's and a distilling part's arguments
    (beside a salt; none means 0); with ``--cut``, below 0, not an integer
    or without a value it raises before any work."""
    inp, out = _ghz6_in(tmp_path), tmp_path / "out"
    full = argv[:2] + [str(inp), str(out)] + argv[2:]
    if isinstance(seed, str):
        with pytest.raises(ValueError, match=seed):
            chip_smoke.scaling_part_args(full)
        assert not out.exists()
        return
    assert chip_smoke.scaling_part_args(full)["seed"] == seed


def test_seed_names_the_record_and_the_row(tmp_path):
    """A part at seed 1 writes ``TAG_PART_seed1[_saltK].json`` and its row's
    note says ``seed 1`` (before the stream); at seed 0 the names and note
    are as before."""
    inp, out = _ghz6_in(tmp_path), str(tmp_path / "out")
    base = [str(inp), out]

    def names(*argv):
        return chip_smoke.part_names(chip_smoke.scaling_part_args(
            list(argv[:2]) + base + list(argv[2:])))

    assert names("ghz6_auto", "ce1", "--seed", "1") == (
        "ghz6_auto_ce1_seed1.json", "; seed 1")
    assert names("ghz6_auto", "d", "--seed", "1", "--salt", "2") == (
        "ghz6_auto_d_seed1_salt2.json", "; seed 1; draw stream salt2")
    assert names("ghz6_auto", "d", "--seed", "1", "--row-note", "shared") == (
        "ghz6_auto_d_seed1.json", "; seed 1; shared")
    assert names("ghz6_auto", "d", "--salt", "2") == (
        "ghz6_auto_d_salt2.json", "; draw stream salt2")
    assert names("ghz6_auto", "d") == ("ghz6_auto_d.json", "")
    assert chip_smoke.part_record_name("ghz6_auto", "ce2", 3) == (
        "ghz6_auto_ce2_seed3.json")


def test_split_row_reads_the_seeds_records(tmp_path):
    """At seed 1 the row sums the seed-1 records of the earlier parts, not
    seed 0's beside them."""
    for name, wall in (("ghz6_auto_ce1.json", 1.0),
                       ("ghz6_auto_ce1_seed1.json", 100.0),
                       ("ghz6_auto_ce2_seed1.json", 200.0)):
        with open(tmp_path / name, "w") as f:
            json.dump(dict(wall_s=wall), f)
    res = dict(fidelity=0.97, raw_fidelity=0.75, raw_fidelity_mitigated=0.99,
               trace_distance=0.03)
    _, walls = chip_smoke.split_row(
        "ghz6_auto", chip_smoke.scaling_rung("ghz6_auto"), res,
        str(tmp_path), ["ce1", "ce2", "d"], 50.0, "card", seed=1)
    assert walls == {"ce1": 100.0, "ce2": 200.0, "d": 50.0}


@pytest.mark.parametrize("part,record,match", [
    ("ce2", dict(name="tiny_ce1.json", seed=None), "run at seed 0"),
    ("ce2", dict(name="tiny_ce1.json", seed=0), "run at seed 0"),
    ("ce2", dict(name="tiny_ce1_seed1.json", seed=2), "run at seed 2"),
    ("d", dict(name="tiny_ce2.json", seed=None), "run at seed 0"),
    ("d", dict(name="tiny_ce2_seed1.json", seed=1, sha="0" * 64),
     "left 0000"),
    ("ce2", dict(name="tiny_ce1_seed1.json", seed=1, sha="f" * 64),
     "left ffff")])
def test_a_seed_part_refuses_another_seeds_predecessor(tmp_path, part,
                                                       record, match):
    """A seed-1 ``ce2`` does not resume from a checkpoint whose record says
    another seed (or none: seed 0), nor a seed-1 ``d`` start from parameters
    another seed left or that its predecessor did not leave: ``ValueError``
    before any work (no launch, no output folder)."""
    parts = HELD_OUT_SPLITS["ghz6"]
    inp, out = tmp_path / "in", tmp_path / "out"
    os.makedirs(inp / "tiny_ckpt" / "1")
    for path in (inp / "tiny_ckpt" / "1" / "checkpoint.pt",
                 inp / "tiny_ce2_params.pt", tmp_path / "data.npz"):
        with open(path, "wb") as f:
            f.write(b"stand-in")
    # Every stand-in holds the same bytes, so either part is handed these.
    handed = chip_smoke.file_sha256(str(inp / "tiny_ce2_params.pt"))
    rec = dict(wall_s=1.0, params_out_sha256=record.get("sha", handed))
    if record["seed"] is not None:
        rec["seed"] = record["seed"]
    with open(inp / record["name"], "w") as f:
        json.dump(rec, f)
    ck.fused_chain_walk.launches = 7
    with pytest.raises(ValueError, match=match):
        chip_smoke.scaling_part(ck, "tiny", part, str(inp), str(out),
                                cfg=_tiny(), parts=parts,
                                data=str(tmp_path / "data.npz"),
                                device="cpu", seed=1)
    assert not out.exists() and ck.fused_chain_walk.launches == 7


def test_predecessor_check_passes_its_own_chain(tmp_path):
    """The guard passes a predecessor of the part's seed that left the
    handed parameters, a record made before records had a ``seed`` at seed
    0, one made before they had hashes, a first part and no record."""
    names = ["ce1", "ce2", "d"]
    with open(tmp_path / "t_ce2_seed1.json", "w") as f:
        json.dump(dict(seed=1, params_out_sha256="a" * 64), f)
    chip_smoke.predecessor_check("t", names, "d", str(tmp_path), 1, "a" * 64)
    with open(tmp_path / "t_ce2.json", "w") as f:
        json.dump(dict(params_out_sha256="b" * 64), f)
    chip_smoke.predecessor_check("t", names, "d", str(tmp_path), 0, "b" * 64)
    with open(tmp_path / "t_ce1.json", "w") as f:
        json.dump(dict(wall_s=1.0), f)
    chip_smoke.predecessor_check("t", names, "ce2", str(tmp_path), 0,
                                 "c" * 64)
    chip_smoke.predecessor_check("t", names, "ce1", str(tmp_path), 1, None)
    chip_smoke.predecessor_check("t", names, "d", str(tmp_path / "no"), 2,
                                 "a" * 64)
