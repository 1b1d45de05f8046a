"""What carries the GHZ-6 distillation between the packages, on the CPU.

(a) ``params_to_flax`` undoes ``params_from_flax`` leaf for leaf, on the
``ghz6_auto`` recipe's tree (the ``rqc`` width) and on a cut tree of every
architecture the converter handles; (b) ``tools/flax_to_torch.py --kind
torch_params`` writes the port's committed GHZ-6 CE model as an orbax
snapshot that ``ddqst_tpu`` restores and whose logits equal the port's;
(c) the committed draws (``examples/reference_data/
ghz6_auto_draws_seed0.npz``, ``tools/make_reference_data.py --draws``) are
``jax.random.choice`` on the keys ``ddqst_tpu.train.finetune_chain`` derives
in the recipe at seed 0, checked on its first and last chunk of 25 steps,
with their metadata.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddqst_tpu.config import ModelConfig as JaxModelConfig
from ddqst_tpu.models import build_model as jax_build_model
from ddqst_tpu.utils import checkpoint as jax_ckpt
from ddqst_tpu_torch.campaigns import scaling
from ddqst_tpu_torch.models import (build_model, params_from_flax,
                                    params_to_flax)
from ddqst_tpu_torch.utils.checkpoint import restore_params

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRAWS = os.path.join(ROOT, "examples", "reference_data",
                     "ghz6_auto_draws_seed0.npz")
CE_PARAMS = os.path.join(ROOT, "examples", "reference_params",
                         "ghz6_auto_ce2_params.pt")
TAG, N = "ghz6_auto", 6
ATOL = 1e-5  # logits against flax's


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flax_init(mkw: dict, n: int, t_steps: int, num_circuits: int = 0):
    fm = jax_build_model(JaxModelConfig(**mkw), n, t_steps, num_circuits)
    # A transformer takes basis labels [B, N], a circuit-conditioned
    # model packed (basis, circuit) pairs [B, 2], the rest basis indices.
    shape = ((2, n) if mkw["arch"] == "transformer" else
             (2, 2) if num_circuits else (2,))
    params = fm.init(jax.random.key(0), jnp.zeros((2, n), jnp.int8),
                     jnp.ones((2,), jnp.int32),
                     jnp.zeros(shape, jnp.int32))["params"]
    return fm, jax.tree_util.tree_map(np.asarray, params)


def _assert_same_tree(got, want):
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


CUT = dict(embed_dim=16, hidden_dim=32, num_blocks=2)
TREES = {
    "rqc_width": (dataclasses.asdict(scaling.experiment(TAG)[0].model), N,
                  100, 0),
    "film_mlp_token": (dict(arch="film_mlp", input_encoding="token", **CUT),
                       3, 8, 0),
    "film_mlp_float": (dict(arch="film_mlp", input_encoding="float", **CUT),
                       3, 8, 0),
    "film_mlp_circuits": (dict(arch="film_mlp", input_encoding="token",
                               **CUT), 2, 8, 5),
    "plain_mlp": (dict(arch="plain_mlp", **CUT), 1, 8, 0),
    "transformer": (dict(arch="transformer", input_encoding="token",
                         num_heads=2, **CUT), 3, 8, 0),
}


@pytest.mark.parametrize("which", list(TREES))
def test_params_to_flax_inverts_params_from_flax(which):
    mkw, n, t_steps, circuits = TREES[which]
    mkw = {k: v for k, v in mkw.items()
           if k in JaxModelConfig.__dataclass_fields__}
    _, params = _flax_init(mkw, n, t_steps, circuits)
    heads = mkw["num_heads"] if mkw["arch"] == "transformer" else None
    _assert_same_tree(params_to_flax(params_from_flax(params), heads),
                      params)
    if heads:
        with pytest.raises(ValueError, match="num_heads"):
            params_to_flax(params_from_flax(params))


def test_port_model_as_an_orbax_snapshot_gives_the_ports_logits(tmp_path):
    """The committed GHZ-6 CE model through ``--kind torch_params``:
    ``ddqst_tpu``'s ``restore_params`` reads it into the recipe's tree, and
    flax's logits on 256 random rows equal the port's within 1e-5."""
    f2t = _load("tools/flax_to_torch.py", "flax_to_torch")
    out = str(tmp_path / "ghz6_ce2")
    assert f2t.main(["--kind", "torch_params", "--src", CE_PARAMS, "--out",
                     out]) == 0
    cfg = scaling.experiment(TAG)[0]
    t_steps = cfg.diffusion.num_timesteps
    fm, template = _flax_init(
        {k: v for k, v in dataclasses.asdict(cfg.model).items()
         if k in JaxModelConfig.__dataclass_fields__}, N, t_steps)
    flax_params = jax.tree_util.tree_map(
        np.asarray, jax_ckpt.restore_params(out, template))
    _assert_same_tree(flax_params, params_to_flax(
        torch.load(CE_PARAMS, weights_only=True)))
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2, (256, N)).astype(np.int8)
    t = rng.integers(1, t_steps + 1, 256).astype(np.int32)
    b = rng.integers(0, 3**N, 256).astype(np.int32)
    want = np.asarray(fm.apply({"params": flax_params}, jnp.asarray(x),
                               jnp.asarray(t), jnp.asarray(b)))
    model = restore_params(CE_PARAMS, build_model(cfg.model, N,
                                                  t_steps)).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long(),
                    torch.from_numpy(b).long())
    assert got.shape == want.shape == (256, N, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def draws():
    tool = _load("tools/make_reference_data.py", "make_reference_data")
    with np.load(DRAWS) as f:
        return tool, {k: f[k] for k in f.files}


def test_committed_draws_metadata(draws):
    tool, f = draws
    tr = tool.rung_cfg(TAG).train
    assert f["draws"].dtype == np.int16
    assert f["draws"].shape == (tr.chain_finetune_steps,
                                tr.chain_basis_batch) == (800, 96)
    assert (f["tag"].item(), int(f["seed"]), int(f["salt"]),
            int(f["steps_per_call"])) == (TAG, 0, 0, 25)
    assert f["jax_version"].item().count(".") == 2  # the jax that drew them
    rows = f["draws"].astype(np.int64)
    assert rows.min() >= 0 and rows.max() < 3**N
    assert all(len(set(r)) == tr.chain_basis_batch for r in rows)


@pytest.mark.parametrize("chunk", [0, 31])
def test_committed_draws_are_jax_random_choice(draws, chunk):
    """Steps 0-24 and 775-799: ``jax.random.choice(k, 729, (96,),
    replace=False)`` for each of the 25 keys split from ``fold_in(key,
    25·chunk)``, ``key`` as ``ddqst_tpu.pipeline.run_experiment`` derives
    it (``fold_in(k_train, 0xD157 + chain_key_salt)``)."""
    tool, f = draws
    _, k_train, _ = jax.random.split(jax.random.key(0), 3)
    key = jax.random.fold_in(k_train, 0xD157 + 0)
    done = 25 * chunk
    keys = jax.random.split(jax.random.fold_in(key, done), 25)
    want = np.stack([np.asarray(jax.random.choice(k, 3**N, (96,),
                                                  replace=False))
                     for k in keys])
    np.testing.assert_array_equal(f["draws"][done:done + 25], want)
    np.testing.assert_array_equal(
        tool.chunk_draws(tool.distill_key(0, 0), done, 25, 3**N, 96), want)
