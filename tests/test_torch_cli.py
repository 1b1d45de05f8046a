"""The port's CLI at tiny budgets, mirroring tests/test_cli.py (CPU)."""

import csv
import os

import numpy as np
import pytest
import torch

from ddqst_tpu_torch import cli
from ddqst_tpu_torch.data import records

# The suite runs in several xdist workers; one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)

TINY = ["--num_qubits", "2", "--epochs", "2", "--batch_size", "64",
        "--embed_dim", "8", "--hidden_dim", "32", "--num_blocks", "1",
        "--timesteps", "8"]


def _generate(tmp_path, samples=4):
    ds = str(tmp_path / "ds")
    rc = cli.main([
        "generate", "--samples", str(samples), "--qubits", "2",
        "--chunk_size", "2", "--shots", "64", "--noise", "readout",
        "--max_bases", "9", "--out_dir", ds, "--device", "cpu",
    ])
    assert rc == 0
    return ds


def test_cli_generate_and_train_and_evaluate(tmp_path):
    ds = _generate(tmp_path)
    assert len([f for f in os.listdir(ds) if f.endswith(".npz")]) == 2

    exp = str(tmp_path / "exp")
    rc = cli.main(["train", "--preset", "rqc", "--data_path", ds,
                   "--save_dir", exp, "--run_name", "m",
                   "--num_eval_circuits", "2", "--device", "cpu", *TINY])
    assert rc == 0
    assert os.path.exists(f"{exp}/m_eval.npz")
    assert os.path.exists(f"{exp}/m_params.pt")

    out = str(tmp_path / "results")
    rc = cli.main(["evaluate", "--preset", "rqc", "--params", f"{exp}/m_params.pt",
                   "--eval_data", f"{exp}/m_eval.npz", "--shots_infer", "100",
                   "--out_dir", out, "--device", "cpu", *TINY])
    assert rc == 0
    with open(f"{out}/metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2
    assert all(0 <= float(r["raw_fidelity"]) <= 1.001 for r in rows)


def test_cli_circuit_conditioned_route(tmp_path):
    """Train with --condition_on_circuit on 4 circuits, evaluate with the
    training circuit count; another count fails the strict params load."""
    ds = _generate(tmp_path)
    exp = str(tmp_path / "exp")
    cond = ["--preset", "rqc", "--condition_on_circuit", "--device", "cpu",
            *TINY]
    assert cli.main(["train", "--data_path", ds, "--save_dir", exp,
                     "--run_name", "c", "--num_eval_circuits", "4", *cond]) == 0
    out = str(tmp_path / "res")
    args = ["evaluate", "--params", f"{exp}/c_params.pt", "--eval_data",
            f"{exp}/c_eval.npz", "--shots_infer", "50", "--out_dir", out, *cond]
    assert cli.main([*args, "--num_circuits", "4"]) == 0
    with open(f"{out}/metrics.csv") as f:
        assert len(list(csv.DictReader(f))) == 4
    with pytest.raises(RuntimeError):
        cli.main([*args, "--num_circuits", "5"])


def test_cli_sanity_check(tmp_path):
    exp = str(tmp_path / "sanity")
    rc = cli.main(["train", "--preset", "rqc", "--sanity_check",
                   "--save_dir", exp, "--run_name", "s", "--device", "cpu",
                   *TINY])
    assert rc == 0
    (rec,) = records.load_shard(f"{exp}/s_eval.npz")
    assert rec.hash == "sanity"


def test_cli_run_minimal(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = cli.main([
        "run", "--preset", "special_states", "--epochs", "2",
        "--embed_dim", "8", "--hidden_dim", "32", "--num_blocks", "1",
        "--timesteps", "8", "--shots_train", "100", "--shots_infer", "100",
        "--device", "cpu", "--plots",
    ])
    assert rc == 0
    for suffix in ("city", "error_heatmap", "loss"):
        assert (tmp_path / f"special_states_{suffix}.png").exists()


def _run_and_capture(args, capsys):
    assert cli.main(args) == 0
    return capsys.readouterr().out


def test_cli_run_bench_recipe_tiny(capsys):
    """The bench recipe through ``run`` at a tiny budget: renoise sampler,
    readout noise with both mitigations, MLE, distillation with a held-out
    split against the MLE-projected target."""
    out = _run_and_capture([
        "run", "--preset", "rqc", "--state_type", "ghz", "--noise_type",
        "readout", "--mitigate_readout", "--mitigate_train_data",
        "--shots_train", "200", "--shots_infer", "500", "--epochs", "2",
        "--timesteps", "8", "--embed_dim", "8", "--hidden_dim", "32",
        "--num_blocks", "1", "--sampler", "renoise", "--reconstruction", "mle",
        "--chain_finetune_steps", "6", "--chain_lr", "1e-3",
        "--chain_val_fraction", "0.15", "--chain_val_patience", "2",
        "--chain_steps_per_call", "2", "--chain_target", "mle",
        "--device", "cpu"], capsys)
    assert "exact-chain distillation: 6 steps" in out
    assert "distillation target: MLE Born probs" in out
    assert "chain CE (full grid)" in out and "held-out best" in out
    assert "exact factorised posterior" not in out  # renoise
    assert "fidelity=" in out


def test_cli_run_chain_basis_batch_and_counts_target(capsys):
    out = _run_and_capture([
        "run", "--preset", "rqc", "--shots_train", "100", "--shots_infer",
        "200", "--epochs", "1", "--timesteps", "8", "--embed_dim", "8",
        "--hidden_dim", "32", "--num_blocks", "1", "--chain_finetune_steps",
        "3", "--chain_basis_batch", "9", "--chain_target", "counts",
        "--device", "cpu"], capsys)
    assert "exact-chain distillation: 3 steps" in out
    assert "MLE Born probs" not in out and "held-out" not in out


def test_cli_run_on_a_basis_subset(capsys):
    """--max_bases below 3^N: the dense inverter reconstructs the raw shots,
    and distillation (which needs every basis) is skipped with a warning."""
    out = _run_and_capture([
        "run", "--preset", "rqc", "--max_bases", "6", "--shots_train", "100",
        "--shots_infer", "200", "--epochs", "1", "--timesteps", "8",
        "--embed_dim", "8", "--hidden_dim", "32", "--num_blocks", "1",
        "--chain_finetune_steps", "3", "--reconstruction", "mle",
        "--device", "cpu"], capsys)
    assert "WARNING: chain distillation skipped" in out
    assert "fidelity=" in out


def test_cli_evaluate_mle_on_records_with_a_basis_subset(tmp_path):
    """generate --max_bases 5 (of 9), train, evaluate --reconstruction mle
    with readout mitigation."""
    ds = str(tmp_path / "ds")
    assert cli.main(["generate", "--samples", "3", "--qubits", "2",
                     "--chunk_size", "3", "--shots", "64", "--noise",
                     "readout", "--max_bases", "5", "--out_dir", ds,
                     "--device", "cpu"]) == 0
    assert records.load_dataset(ds)[0].counts.shape == (5, 4)
    exp = str(tmp_path / "exp")
    assert cli.main(["train", "--preset", "rqc", "--data_path", ds,
                     "--save_dir", exp, "--run_name", "m",
                     "--num_eval_circuits", "2", "--device", "cpu",
                     *TINY]) == 0
    out = str(tmp_path / "res")
    assert cli.main(["evaluate", "--preset", "rqc", "--params",
                     f"{exp}/m_params.pt", "--eval_data", f"{exp}/m_eval.npz",
                     "--shots_infer", "100", "--reconstruction", "mle",
                     "--noise_type", "readout", "--mitigate_readout",
                     "--out_dir", out, "--device", "cpu", *TINY]) == 0
    with open(f"{out}/metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2
    assert all(0 <= float(r["raw_fidelity"]) <= 1.001 for r in rows)


def test_cli_convert(tmp_path):
    entries = [{
        "clean_state_vec": np.array([1, 0, 0, 0], np.complex64),
        "measurements": [{"basis": "ZZ", "counts": {"00": 60, "11": 4}}],
        "id": 0, "hash": "h", "depth": 2,
    }]
    src = str(tmp_path / "part_0.pt")
    torch.save(entries, src)
    out = str(tmp_path / "conv")
    assert cli.main(["convert", "--src", src, "--out", out]) == 0
    (rec,) = records.load_shard(os.path.join(out, "part_0.npz"))
    np.testing.assert_array_equal(rec.counts, [[60, 0, 0, 4]])


def test_cli_without_device_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        cli.main(["generate", "--samples", "2", "--qubits", "2",
                  "--out_dir", str(tmp_path / "ds")])
    with pytest.raises(RuntimeError):
        cli.main(["train", "--sanity_check", "--save_dir", str(tmp_path),
                  *TINY])


def test_cli_data_parallel_is_not_ported(tmp_path):
    """``train`` takes ``--data_parallel`` and ignores it, as the JAX
    package's does (only ``run`` reads it)."""
    assert cli.main(["train", "--sanity_check", "--save_dir", str(tmp_path),
                     "--data_parallel", "8", "--device", "cpu", *TINY]) == 0
    assert os.path.exists(tmp_path / "model_params.pt")


def test_module_entry_point_runs():
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-m", "ddqst_tpu_torch.cli", "--help"],
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0
    for sub in ("run", "generate", "train", "evaluate", "convert"):
        assert sub in out.stdout


def test_cli_run_data_parallel_needs_a_world_of_that_size(tmp_path,
                                                         monkeypatch):
    """``run --data_parallel 1`` needs no launcher (a one-process world);
    a larger R outside a world of R processes raises with the torchrun
    command line."""
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.chdir(tmp_path)
    flags = ["--device", "cpu", "--shots_train", "128", "--shots_infer", "200",
             *TINY]
    assert cli.main(["run", "--data_parallel", "1", *flags]) == 0
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        cli.main(["run", "--data_parallel", "2", *flags])
