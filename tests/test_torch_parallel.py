"""The port's meshes against tests/test_parallel.py: two ranks of one gloo
world on the CPU (spawned once for the module; the rank processes are in
tests/test_torch_parallel_workers.py), against one process and against the
JAX package's shardings and flax's forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel_workers as workers
from ddqst_tpu.models.transformer import TransformerDenoiser as FlaxTransformer
from ddqst_tpu.parallel import mesh as jpm
from ddqst_tpu_torch import pipeline as tpipe
from ddqst_tpu_torch.config import ModelConfig
from ddqst_tpu_torch.models import build_model
from ddqst_tpu_torch.parallel import init_distributed, transformer_param_shardings

# The suite runs in several xdist workers; one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5  # tests/test_parallel.py's DP / TP tolerance


def _flax_transformer():
    """tests/test_parallel.py:56-80: n=4, E=16, hidden 64, 2 blocks, 2
    heads, T=8; flax's initial params and forward."""
    fm = FlaxTransformer(num_qubits=4, num_timesteps=8, embed_dim=16,
                         hidden_dim=64, num_blocks=2, num_heads=2)
    x = jnp.asarray(np.random.default_rng(0).integers(0, 2, (16, 4)), jnp.int8)
    t = jnp.ones((16,), jnp.int32)
    b = jnp.zeros((16,), jnp.int32)
    params = fm.init(jax.random.key(0), x, t, b)["params"]
    return fm, params, (x, t, b)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("parallel"))
    fm, params, (x, t, b) = _flax_transformer()
    flax_file = f"{tmp}/flax.pt"
    torch.save({"params": jax.tree_util.tree_map(np.asarray, params),
                "x": np.asarray(x), "t": np.asarray(t), "b": np.asarray(b)},
               flax_file)
    ranks = workers.spawn_world(workers.two_rank_checks, 2, tmp, flax_file)
    return ranks, np.asarray(fm.apply({"params": params}, x, t, b))


def test_mesh_layout(world):
    ranks, _ = world
    for r, out in enumerate(ranks):
        dp, tpm, default = out["layout"]
        assert dp["shape"] == {"data": 2, "model": 1}
        assert dp["coords"] == (r, 0) and dp["data_ranks"] == (0, 1)
        assert dp["model_ranks"] == (r,)
        assert tpm["shape"] == {"data": 1, "model": 2}
        assert tpm["coords"] == (0, r) and tpm["model_ranks"] == (0, 1)
        assert default["shape"] == {"data": 2, "model": 1}  # data=-1
        assert dp["backend"] == "gloo" and dp["device"] == "cpu"


def test_data_parallel_training_matches_one_process(world):
    ranks, _ = world
    losses, state, _ = workers.fit(workers.dp_setup)
    for out in ranks:
        np.testing.assert_allclose(out["dp_losses"].numpy(), losses.numpy(),
                                   rtol=RTOL, atol=ATOL)
        assert out["dp_losses"].shape == (3,)
    # Both ranks hold the same model, bit for bit.
    for k, v in ranks[0]["dp_state"].items():
        assert torch.equal(v, ranks[1]["dp_state"][k])


def test_data_parallel_checkpoint_resume_equals_the_uninterrupted_run(world):
    """Rank 0 writes the checkpoint of epoch 1; the resumed ranks train
    epochs 2-3 as the uninterrupted run did, bit for bit."""
    for out in world[0]:
        losses, state = out["dp_resumed"]
        assert torch.equal(losses, out["dp_losses"][1:])
        assert all(torch.equal(v, out["dp_state"][k]) for k, v in state.items())


def test_tensor_parallel_forward_matches_flax(world):
    ranks, ref = world
    for out in ranks:
        np.testing.assert_allclose(out["tp_logits"].numpy(), ref, atol=2e-5)
        np.testing.assert_allclose(out["gathered_logits"].numpy(), ref,
                                   atol=2e-5)
        local, whole = out["tp_local_shapes"], out["tp_whole_shapes"]
        split = [k for k in whole if local[k] != whole[k]]
        assert len(split) == 10 * 2  # 10 rules x 2 blocks
        assert local["blocks.0.attn.query.weight"] == (8, 16)
        assert local["blocks.1.attn.out.weight"] == (16, 8)
        assert local["blocks.0.mlp1.bias"] == (32,)


def test_shard_then_gather_returns_the_same_bits(world):
    ranks, _ = world
    assert all(out["gather_same_bits"] for out in ranks)


def test_sharded_sampling(world):
    """p_sample over rows sharded across the data axis, gathered."""
    ranks, _ = world
    out = ranks[0]["p_sample"]
    assert out.shape == (64, 3)
    assert 0.2 < float(out.float().mean()) < 0.8
    assert torch.equal(out, ranks[1]["p_sample"])  # the same whole
    assert not torch.equal(out[:32], out[32:])  # each rank drew its own


def test_replicate_broadcasts_rank_0s_tensor(world):
    ranks, _ = world
    assert all(torch.equal(out["replicated"], torch.zeros(3)) for out in ranks)


def test_grid_sampler_sharded(world):
    ranks, _ = world
    out = ranks[0]["p_sample_grid"]
    assert out.shape == (160, 2)
    assert torch.equal(out, ranks[1]["p_sample_grid"])


@pytest.mark.parametrize("what,match", [
    ("uneven batch", "does not divide by the data axis"),
    ("heads", "must both divide by the model axis"),
    ("mesh size", "does not cover the world"),
    ("uneven rows", "does not split into 2 equal parts"),
])
def test_mesh_value_errors(world, what, match):
    ranks, _ = world
    for out in ranks:
        assert match in out["errors"][what]


def test_run_experiment_on_a_mesh_matches_one_process(world):
    """run_experiment(mesh=) data-parallel over 2 ranks: both ranks return
    the same result bit for bit, and the losses are one process's."""
    ranks, _ = world
    a, b = ranks[0]["run"], ranks[1]["run"]
    assert a["fidelity"] == b["fidelity"] and np.array_equal(a["rho"], b["rho"])
    assert torch.equal(a["samples"], b["samples"])
    assert all(torch.equal(v, b["state"][k]) for k, v in a["state"].items())
    one = tpipe.run_experiment(workers.small_rqc(), seed=0, device="cpu",
                               log_fn=lambda m: None)
    np.testing.assert_allclose(a["losses"], one["losses"], rtol=RTOL,
                               atol=ATOL)
    assert a["train_steps"] == one["train_steps"]
    assert a["samples"].shape == one["samples"].shape == (27, workers.SHOTS, 3)
    rho = a["rho"]
    assert abs(np.trace(rho) - 1) < 1e-4
    assert np.linalg.eigvalsh(rho).min() > -1e-5


def _torch_name(path: str) -> tuple[str, int]:
    """A flax path of the transformer's params -> (the port's name, the
    number of leading input axes of its kernel)."""
    parts = path.split("/")
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight",
            "bias": "bias"}.get(parts[-1])
    mods = parts[:-1]
    if mods and mods[0].startswith("block_"):
        mods[0] = "blocks." + mods[0].split("_")[1]
    name = ".".join(mods + [leaf]) if leaf else ".".join(parts)
    return name, 2 if path.endswith("attn/out/kernel") else 1


def test_transformer_param_shardings_match_jax():
    """The port's rules against JAX's on the same model: names mapped,
    dimensions transposed (torch's Linear weight is flax's kernel
    transposed, with DenseGeneral's axes flattened). The one difference:
    the q/k/v biases, which JAX replicates and the port splits with its
    local heads."""
    fm = FlaxTransformer(num_qubits=4, num_timesteps=8, embed_dim=16,
                         hidden_dim=64, num_blocks=2, num_heads=2)
    params = fm.init(jax.random.key(0), jnp.zeros((2, 4), jnp.int8),
                     jnp.ones((2,), jnp.int32),
                     jnp.zeros((2,), jnp.int32))["params"]
    mesh = jpm.make_mesh(data=4, model=2)
    specs = jpm.transformer_param_shardings(mesh, params)
    want = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(specs)[0]:
        key = "/".join(str(k.key) for k in path)
        name, in_axes = _torch_name(key)
        axes = [i for i, a in enumerate(sharding.spec) if a == "model"]
        if not axes:
            want[name] = None
        elif key.endswith("bias"):
            want[name] = 0
        else:
            want[name] = 1 if axes[0] < in_axes else 0
    model = build_model(ModelConfig(arch="transformer", embed_dim=16,
                                    hidden_dim=64, num_blocks=2, num_heads=2),
                        4, 8)
    got = transformer_param_shardings(model)
    assert set(got) == set(want)
    qkv_bias = {f"blocks.{i}.attn.{q}.bias" for i in range(2)
                for q in ("query", "key", "value")}
    for name in want:
        if name in qkv_bias:
            assert want[name] is None and got[name] == 0, name
        else:
            assert got[name] == want[name], name
    assert sum(d is not None for d in want.values()) == 7 * 2


def test_film_mlp_matches_no_rule():
    model = build_model(ModelConfig(), 3, 10)
    assert set(transformer_param_shardings(model).values()) == {None}


def test_init_distributed_single_process_noop(monkeypatch):
    """tests/test_parallel.py:154-161: one process, and no torchrun
    environment, are a no-op."""
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed(num_processes=1) is False
    assert init_distributed() is False
    assert not torch.distributed.is_initialized()
