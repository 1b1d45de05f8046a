"""Port parity: the JAX package's saved params and distillation Adam states
read into the port through ``tools/flax_to_torch.py``; the reference's own
N=10 CE snapshot (``shadow_work/dist_seg_ce_params``) as the port's model,
against flax's logits and ``ddqst_tpu``'s tables; the shadow route's metric
helper on the reference's data cache; and ``chip_smoke``'s copy of the
reference's recipe (CPU)."""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddqst_tpu.models import build_model as jax_build_model
from ddqst_tpu.ops import diffusion as jdiff
from ddqst_tpu.ops import schedules as jsched
from ddqst_tpu.utils import checkpoint as jax_ckpt
from ddqst_tpu_torch import train as ttrain
from ddqst_tpu_torch.models import build_model, params_from_flax
from ddqst_tpu_torch.ops import diffusion as tdiff
from ddqst_tpu_torch.ops import schedules as tsched
from ddqst_tpu_torch.ops.mle import bits_to_counts
from ddqst_tpu_torch.pipeline import load_data_cache, shadow_metrics
from ddqst_tpu_torch.utils.checkpoint import (restore_chain_opt,
                                              restore_params)

import chip_smoke

# The suite runs in several xdist workers; one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "shadow_work", "dist_seg_ce_params")
CACHE = os.path.join(REPO, "shadow_work", "dist_seg_data.npz")
COMMITTED = os.path.join(REPO, "examples", "reference_params",
                         "dist_seg_ce_params.pt")
ATOL = 1e-5  # logits and tables against the JAX package


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


f2t = _load("tools/flax_to_torch.py", "flax_to_torch")


@pytest.fixture(scope="module")
def flax_params():
    return jax.tree_util.tree_map(np.asarray,
                                  jax_ckpt.restore_params(SNAPSHOT, None))


@pytest.fixture(scope="module")
def reference():
    """The reference's recipe (the JAX package's and the port's configs),
    its data cache and the committed snapshot as the port's model."""
    rss = _load("scripts/run_shadow_scale.py", "run_shadow_scale")
    jcfg = rss.make_cfg("dist_seg", max_bases=300)
    cfg = chip_smoke.reference_shadow_cfg()
    model = build_model(cfg.model, 10, cfg.diffusion.num_timesteps)
    restore_params(COMMITTED, model).eval()
    return jcfg, cfg, load_data_cache(CACHE), model


def _expected(path: tuple, leaf: np.ndarray) -> tuple[str, np.ndarray]:
    """The port's name and value of one flax leaf, by the documented
    layouts: a Dense kernel ``[in, out]`` transposed; the attention's
    q/k/v kernels ``[E, H, D]`` as ``[E, H·D]`` and its output kernel
    ``[H, D, E]`` as ``[H·D, E]``, then transposed; a ``[H, D]`` bias
    flattened; an Embed table as it is; a LayerNorm's scale as its
    weight."""
    keys = list(path)
    if keys[0].startswith("block_"):
        keys[0] = f"blocks.{keys[0].split('_')[1]}"
    last = keys[-1]
    if last == "embedding":
        return ".".join(keys[:-1] + ["weight"]), leaf
    if last == "scale":
        return ".".join(keys[:-1] + ["weight"]), leaf
    if last == "kernel":
        in_dims = 2 if keys[-2] == "out" else 1
        k = leaf.reshape(int(np.prod(leaf.shape[:in_dims])), -1)
        return ".".join(keys[:-1] + ["weight"]), k.T
    if last == "bias":
        return ".".join(keys), leaf.reshape(-1)
    return ".".join(keys), leaf  # pos_emb


def _flat(tree) -> list[tuple[tuple, np.ndarray]]:
    return [(tuple(k.key for k in path), leaf) for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree)]


def test_converter_copies_every_flax_leaf_bit_for_bit(flax_params, tmp_path):
    out = str(tmp_path / "dist_seg_ce_params.pt")
    sd = f2t.convert_params(SNAPSHOT, out)
    leaves = _flat(flax_params)
    assert len(leaves) == len(sd) == 80
    assert sum(v.numel() for v in sd.values()) == 940_546
    for path, leaf in leaves:
        assert leaf.dtype == np.float32, path
        name, want = _expected(path, leaf)
        got = sd[name]
        assert got.dtype == torch.float32 and got.is_contiguous(), name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert torch.load(out, weights_only=True).keys() == sd.keys()


def test_committed_params_equal_a_fresh_conversion(tmp_path):
    out = str(tmp_path / "dist_seg_ce_params.pt")
    assert f2t.main(["--kind", "params", "--src", SNAPSHOT, "--out",
                     out]) == 0
    fresh = torch.load(out, weights_only=True)
    committed = torch.load(COMMITTED, weights_only=True)
    assert list(fresh) == list(committed)
    for name, t in committed.items():
        assert t.dtype == fresh[name].dtype and torch.equal(t, fresh[name]), \
            name


def test_converter_accepts_a_params_key_and_refuses_bfloat16(flax_params,
                                                             tmp_path):
    """A snapshot saved as ``{'params': tree}`` converts to the same state
    dict; a bfloat16 leaf raises instead of being cast."""
    wrapped = str(tmp_path / "wrapped")
    jax_ckpt.save_params(wrapped, {"params": flax_params})
    sd = f2t.convert_params(wrapped, str(tmp_path / "w.pt"))
    assert all(torch.equal(sd[k], v)
               for k, v in params_from_flax(flax_params).items())
    bf = str(tmp_path / "bf16")
    jax_ckpt.save_params(bf, {"pos_emb": jnp.zeros((10, 128), jnp.bfloat16)})
    with pytest.raises(ValueError, match="bfloat16"):
        f2t.convert_params(bf, str(tmp_path / "bf.pt"))


def test_reference_logits_match_flax(flax_params, reference):
    """The reference's model, converted, gives flax's logits on 512 rows of
    its own data cache (random t), within 1e-5."""
    jcfg, cfg, data, model = reference
    rng = np.random.default_rng(0)
    b = rng.integers(0, 300, 512)
    x = np.asarray(data.bits)[b, rng.integers(0, 1024, 512)]
    t = rng.integers(1, cfg.diffusion.num_timesteps + 1, 512).astype(np.int32)
    labels = np.asarray(data.basis_labels)[b].astype(np.int32)
    fm = jax_build_model(jcfg.model, 10, jcfg.diffusion.num_timesteps)
    want = np.asarray(fm.apply({"params": flax_params}, jnp.asarray(x),
                               jnp.asarray(t), jnp.asarray(labels)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long(),
                    torch.from_numpy(labels).long())
    assert got.shape == want.shape == (512, 10, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_reference_tables_match_jax(flax_params, reference):
    """The shadow route's grid tables of the reference's model for bases 0
    and 299 at t = 100, 50, 1 equal ``ddqst_tpu``'s ``_tables_for_ts`` on
    the same grid, within 1e-5."""
    jcfg, cfg, data, model = reference
    n, t_steps = 10, cfg.diffusion.num_timesteps
    g = 2**n
    labels = np.asarray(data.basis_labels)[[0, 299]].astype(np.int32)
    grid_x = np.tile(((np.arange(g)[:, None] >> np.arange(n)) & 1)
                     .astype(np.int8), (2, 1))
    grid_lab = np.repeat(labels, g, axis=0)
    ts = np.array([t_steps, t_steps // 2, 1])
    exact = cfg.diffusion.exact
    assert exact == jcfg.diffusion.exact is False
    fm = jax_build_model(jcfg.model, n, jcfg.diffusion.num_timesteps)
    want = jdiff._tables_for_ts(
        lambda x, t, b: fm.apply({"params": flax_params}, x, t, b),
        jnp.asarray(ts), n, jsched.cosine_schedule(t_steps), exact,
        grid=(jnp.asarray(grid_x), jnp.asarray(grid_lab)))
    with torch.no_grad():
        got = tdiff._tables_for_ts(
            model, torch.from_numpy(ts), n, tsched.cosine_schedule(t_steps),
            exact, grid=(torch.from_numpy(grid_x),
                         torch.from_numpy(grid_lab).long()))
    assert got.shape == (3, 2 * g, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("arch", ["transformer", "film_mlp"])
def test_chain_opt_round_trip(arch, tmp_path):
    """A distillation Adam state of a tiny model, written by
    ``ddqst_tpu.utils.checkpoint.save_params`` as the JAX pipeline's
    ``opt_save`` writes it, converts into the file ``restore_chain_opt``
    accepts strictly, with each moment laid out as its parameter."""
    from ddqst_tpu.config import ModelConfig as JaxModelConfig
    from ddqst_tpu_torch.config import ModelConfig

    n, t_steps = 3, 8
    mkw = dict(arch=arch, input_encoding="token", embed_dim=16,
               hidden_dim=32, num_blocks=1, num_heads=2)
    fm = jax_build_model(JaxModelConfig(**mkw), n, t_steps)
    basis = (jnp.zeros((2, n), jnp.int32) if arch == "transformer"
             else jnp.zeros((2,), jnp.int32))
    params = fm.init(jax.random.key(0), jnp.zeros((2, n), jnp.int8),
                     jnp.ones((2,), jnp.int32), basis)["params"]
    rng = np.random.default_rng(1)

    def moments(scale):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(scale * rng.random(a.shape, np.float32)),
            params)

    src = str(tmp_path / "opt")
    jax_ckpt.save_params(src, {"count": jnp.asarray(17, jnp.int32),
                               "mu": moments(1.0), "nu": moments(1e-3)})
    out = str(tmp_path / "opt.pt")
    assert f2t.main(["--kind", "chain_opt", "--src", src, "--out", out]) == 0
    model = build_model(ModelConfig(**mkw), n, t_steps)
    got = restore_chain_opt(out, ttrain.chain_opt_template(model))
    saved = jax.tree_util.tree_map(np.asarray,
                                   jax_ckpt.restore_params(src, None))
    assert int(got["count"]) == 17 and got["count"].dtype == torch.int32
    for key in ("mu", "nu"):
        want = params_from_flax(saved[key])
        assert got[key].keys() == want.keys() == dict(
            model.named_parameters()).keys()
        for name, v in want.items():
            assert torch.equal(got[key][name], v), (key, name)


def test_shadow_metrics_on_the_reference_cache():
    """The shadow route's metric helper on the reference's data cache: the
    shot-noise floor and the measured-data TV, which depend on the cache
    alone, are what ``examples/results_shadow.jsonl`` row 11 rounds; the
    measured counts scored as generated ones score the measured TV."""
    data = load_data_cache(CACHE)
    meas = bits_to_counts(data.bits).numpy()
    m = shadow_metrics(meas, meas, np.asarray(data.clean_probs), 5000, 10)
    assert m["tv_shot_noise_floor"] == pytest.approx(0.1195379, abs=5e-8)
    assert m["meas_tv_to_target"] == pytest.approx(0.2662557, abs=5e-8)
    row = chip_smoke.REFERENCE_SHADOW[chip_smoke.REFERENCE_SNAPSHOT_ROW]
    for k in ("tv_shot_noise_floor", "meas_tv_to_target"):
        assert round(m[k], 5) == row[k]
    assert m["mean_tv_to_target"] == m["meas_tv_to_target"]
    assert 0 < m["mean_marginal_error"] < m["max_marginal_error"]
    assert 0 < m["classical_fidelity"] < 1


def test_chip_smoke_reference_cfg_is_make_cfg(reference):
    """``chip_smoke.reference_shadow_cfg`` equals
    ``run_shadow_scale.make_cfg("dist_seg", max_bases=300)`` field by
    field."""
    jcfg, cfg = reference[:2]
    want, got = dataclasses.asdict(jcfg), dataclasses.asdict(cfg)
    assert want.keys() == got.keys()
    for section, fields in want.items():
        assert fields == got[section], section
