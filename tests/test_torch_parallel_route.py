"""Data x tensor parallel training and the shadow route on a 2 x 2 mesh (four
spawned ranks of one gloo world on the CPU), against one process; and
``cli run --data_parallel 2`` under torchrun. The counterparts of
tests/test_parallel.py:84-125 and of ``ddqst_tpu/cli.py``'s ``_mesh_for``."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_parallel_workers as workers
from ddqst_tpu_torch import pipeline as tpipe
from ddqst_tpu_torch.parallel import transformer_param_shardings

# The suite runs in several xdist workers; one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-4, 2e-5  # tests/test_parallel.py's DP / TP tolerance


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("parallel_route"))
    return workers.spawn_world(workers.four_rank_checks, 4, tmp)


def test_mesh_layout_2x2(world):
    for r, out in enumerate(world):
        lay = out["layout"]
        assert lay["shape"] == {"data": 2, "model": 2}
        assert lay["coords"] == divmod(r, 2)
        assert lay["data_ranks"] == (r % 2, r % 2 + 2)  # the model column
        assert lay["model_ranks"] == (r - r % 2, r - r % 2 + 1)  # the data row


def test_tensor_parallel_training_experiment_scale(world):
    """fit over a 2 x 2 mesh at the N=10 experiment widths: the losses of
    one process, the whole model the same on every rank, and the Adam
    moments of the split parameters local to each rank."""
    losses, state, _ = workers.fit(workers.tp_setup)
    for out in world:
        np.testing.assert_allclose(out["tp_losses"].numpy(), losses.numpy(),
                                   rtol=RTOL, atol=ATOL)
    for out in world[1:]:
        assert all(torch.equal(v, out["tp_state"][k])
                   for k, v in world[0]["tp_state"].items())
    model = workers.tp_setup()[0]
    dims = transformer_param_shardings(model)
    whole = {k: tuple(p.shape) for k, p in model.named_parameters()}
    for out in world:
        local = out["moment_shapes"]
        assert local.keys() == whole.keys()
        split = 0
        for name, dim in dims.items():
            want = list(whole[name])
            if dim is not None:
                want[dim] //= 2
                split += 1
            assert local[name] == (tuple(want), tuple(want)), name
        assert split >= 7 * 2  # JAX's 7 rules x 2 blocks (+ q/k/v biases)


def test_tensor_parallel_checkpoint_resume_equals_the_uninterrupted_run(world):
    """On the 2 x 2 mesh rank 0 writes the whole model and optimiser state
    of epoch 1, and the resume splits it again: epoch 2 as the uninterrupted
    run trained it, bit for bit."""
    for out in world:
        losses, state = out["tp_resumed"]
        assert torch.equal(losses, out["tp_losses"][1:])
        assert all(torch.equal(v, out["tp_state"][k]) for k, v in state.items())


def test_shadow_route_on_a_2x2_mesh_matches_one_process(world):
    """run_experiment(mesh=) on the shadow route: the ranks agree bit for
    bit, and the losses are one process's."""
    a = world[0]["shadow"]
    for out in world[1:]:
        b = out["shadow"]
        assert a["mean_tv_to_target"] == b["mean_tv_to_target"]
        assert torch.equal(a["samples"], b["samples"])
    one = tpipe.run_experiment(workers.small_shadow(), seed=0, device="cpu",
                               log_fn=lambda m: None)
    np.testing.assert_allclose(a["losses"], one["losses"], rtol=RTOL,
                               atol=ATOL)
    assert a["samples"].shape == one["samples"].shape == (8, 300, 7)
    assert 0 <= a["mean_tv_to_target"] <= 1


def test_cli_run_data_parallel_under_torchrun(tmp_path):
    """``torchrun --standalone --nproc_per_node 2 -m ddqst_tpu_torch.cli
    run --data_parallel 2``: both ranks run, rank 0 logs."""
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "ddqst_tpu_torch.cli", "run",
         "--data_parallel", "2", "--device", "cpu", "--num_qubits", "2",
         "--epochs", "2", "--batch_size", "64", "--embed_dim", "8",
         "--hidden_dim", "32", "--num_blocks", "1", "--timesteps", "8",
         "--shots_train", "128", "--shots_infer", "200"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("fidelity=") == 1  # rank 0 alone logs
    assert "2 rank(s), backend gloo" in out.stdout
