"""Port parity: the phase-1 notebook ``PlainMLP`` and the bfloat16 compute
dtype of all three denoisers against the flax models on the same weights,
and the notebook presets' slice against the JAX package (CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddqst_tpu import config as jcfg
from ddqst_tpu import pipeline as jpipe
from ddqst_tpu import train as jtrain
from ddqst_tpu.models import build_model as jbuild_model
from ddqst_tpu.ops import diffusion as jdiff
from ddqst_tpu.ops import metrics as jM
from ddqst_tpu.ops import mle as jmle
from ddqst_tpu.ops import pauli as jpauli
from ddqst_tpu.ops.complexlib import from_complex
from ddqst_tpu.ops.schedules import make_schedule as jmake_schedule
from ddqst_tpu_torch import config as tcfg
from ddqst_tpu_torch import pipeline as tpipe
from ddqst_tpu_torch import train as ttrain
from ddqst_tpu_torch.models import PlainMLP, build_model, params_from_flax
from ddqst_tpu_torch.ops import diffusion as tdiff
from ddqst_tpu_torch.ops import schedules as tsched

# The suite runs in several xdist workers; one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)

T = 20
# bfloat16 keeps 8 significant bits (a relative step of 2^-8 = 0.4%), and
# the two packages round at different points (fused bias add, softmax,
# SiLU), so a logit of a few units may differ by one or two of its steps.
BF16_ATOL, BF16_RTOL = 2e-2, 1e-2


def _pair(arch, n, dtype="float32", seed=1, **widths):
    """A flax model of ``arch`` with seeded float32 weights and the port's
    copy, both computing in ``dtype``."""
    jm = jbuild_model(jcfg.ModelConfig(arch=arch, dtype=dtype, **widths), n, T)
    params = jm.init(jax.random.key(seed), jnp.zeros((2, n), jnp.int8),
                     jnp.ones((2,), jnp.int32),
                     jnp.zeros((2,), jnp.int32))["params"]
    tm = build_model(tcfg.ModelConfig(arch=arch, dtype=dtype, **widths), n, T)
    tm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                               params)))
    return jm, params, tm.eval()


def _inputs(n, b=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, (b, n)).astype(np.int8),
            rng.integers(0, T + 1, b).astype(np.int32),
            rng.integers(0, 3**n, b).astype(np.int32))


def _logits(jm, params, tm, x, t, basis):
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(t), jnp.asarray(basis)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t),
                 torch.from_numpy(basis)).numpy()
    return out, ref


@pytest.mark.parametrize("n,embed,hidden,blocks", [(1, 32, 128, 2),
                                                   (3, 16, 32, 3),
                                                   (2, 8, 16, 0)])
def test_plain_mlp_logits_match_flax(n, embed, hidden, blocks):
    jm, params, tm = _pair("plain_mlp", n, embed_dim=embed, hidden_dim=hidden,
                           num_blocks=blocks)
    assert isinstance(tm, PlainMLP)
    out, ref = _logits(jm, params, tm, *_inputs(n))
    assert out.shape == (64, n, 2) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_plain_mlp_packed_basis_takes_column_zero():
    _, _, tm = _pair("plain_mlp", 2, embed_dim=8, hidden_dim=16, num_blocks=1)
    x, t, basis = (torch.from_numpy(a) for a in _inputs(2))
    packed = torch.stack([basis, torch.full_like(basis, 5)], dim=-1)
    with torch.no_grad():
        assert torch.equal(tm(x, t, packed), tm(x, t, basis))


@pytest.mark.parametrize("preset", ["notebook_simple", "notebook_upgraded"])
def test_notebook_preset_parameter_count_matches_flax(preset):
    jc = jcfg.get_preset(preset)
    n = jc.data.num_qubits
    jm = jbuild_model(jc.model, n, jc.diffusion.num_timesteps)
    params = jm.init(jax.random.key(0), jnp.zeros((2, n), jnp.int8),
                     jnp.ones((2,), jnp.int32),
                     jnp.zeros((2,), jnp.int32))["params"]
    n_flax = sum(int(np.prod(p.shape))
                 for p in jax.tree_util.tree_leaves(params))
    tc = tcfg.get_preset(preset)
    tm = build_model(tc.model, n, tc.diffusion.num_timesteps)
    assert sum(p.numel() for p in tm.parameters()) == n_flax
    if preset == "notebook_simple":  # tests/test_models.py's formula
        assert n_flax == ((65 * 128 + 128) + (128 * 128 + 128)
                          + (128 * 2 + 2) + 101 * 32 + 3 * 32)
    sd = params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    assert sd.keys() == tm.state_dict().keys()


def test_plain_mlp_with_circuits_raises_as_jax():
    cfg = tcfg.ModelConfig(arch="plain_mlp")
    with pytest.raises(ValueError, match="circuit"):
        build_model(cfg, 2, T, num_circuits=4)
    with pytest.raises(ValueError, match="circuit"):
        jbuild_model(jcfg.ModelConfig(arch="plain_mlp"), 2, T, num_circuits=4)


# --- bfloat16 compute ------------------------------------------------------

_ARCHS = [
    ("plain_mlp", dict(embed_dim=16, hidden_dim=32, num_blocks=2)),
    ("film_mlp", dict(embed_dim=16, hidden_dim=32, num_blocks=2,
                      input_encoding="float")),
    ("film_mlp", dict(embed_dim=16, hidden_dim=32, num_blocks=2,
                      input_encoding="token")),
    ("transformer", dict(embed_dim=16, hidden_dim=32, num_blocks=2,
                         num_heads=4)),
]


@pytest.mark.parametrize("arch,widths", _ARCHS,
                         ids=["plain", "film_float", "film_token",
                              "transformer"])
def test_bf16_logits_match_flax_bf16(arch, widths):
    """Float32 parameters, bfloat16 compute, float32 logits: within
    BF16_ATOL + BF16_RTOL·|logit| of flax's ``dtype=bfloat16`` forward, and
    not the float32 forward."""
    n = 3
    jm, params, tm = _pair(arch, n, dtype="bfloat16", **widths)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    inputs = _inputs(n)
    out, ref = _logits(jm, params, tm, *inputs)
    assert out.dtype == np.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=BF16_ATOL, rtol=BF16_RTOL)
    _, _, tm32 = _pair(arch, n, **widths)
    out32, _ = _logits(jm, params, tm32, *inputs)
    assert np.abs(out32 - out).max() > 1e-4  # bf16 really ran


def test_unknown_dtype_raises():
    with pytest.raises(ValueError, match="dtype"):
        build_model(tcfg.ModelConfig(dtype="float8"), 2, T)


def test_bf16_model_trains_samples_and_distils_in_float32():
    """``fit``, the grid tables and ``chain_distribution`` work unchanged on
    a bf16 model: parameters, gradients and optimiser state stay float32,
    the tables and the chain distribution are float32."""
    tm = build_model(tcfg.ModelConfig(arch="film_mlp", dtype="bfloat16",
                                      embed_dim=8, hidden_dim=16,
                                      num_blocks=1), 2, 8)
    rng = np.random.default_rng(0)
    bits = torch.from_numpy(rng.integers(0, 2, (256, 2)).astype(np.int8))
    basis = torch.from_numpy(rng.integers(0, 9, 256))
    sched = tsched.cosine_schedule(8)
    cfg = tcfg.TrainConfig(batch_size=64, num_epochs=2, learning_rate=1e-3,
                           log_every=0, eval_every=0)
    tm, losses = ttrain.fit(torch.Generator().manual_seed(0), tm, bits, basis,
                            cfg, sched, device="cpu")
    assert losses.dtype == torch.float32 and torch.isfinite(losses).all()
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    tables = tdiff.grid_p1_tables(tm, 2, sched)
    assert tables.dtype == torch.float32 and tables.shape == (8, 36, 2)
    dist = tdiff.chain_distribution(tm, 2, sched)
    assert dist.dtype == torch.float32
    torch.testing.assert_close(dist.sum(-1), torch.ones(9), rtol=0, atol=1e-5)
    tm, ft_losses, info = ttrain.finetune_chain(
        tm, dist.detach() * 100, sched, 2, steps=2, device="cpu")
    assert all(v.dtype == torch.float32
               for v in info["final_opt_state"]["mu"].values())
    assert torch.isfinite(ft_losses).all()


# --- the notebook slice against the JAX package ----------------------------

SHOTS = 5000


def _notebook(cfg_mod):
    c = cfg_mod.get_preset("notebook_simple")
    return c.replace(train=dataclasses.replace(c.train, num_epochs=2),
                     data=dataclasses.replace(c.data, shots_infer=SHOTS))


def test_notebook_slice_on_a_jax_cache_and_weights(tmp_path):
    """The notebook preset's route on the JAX package's data cache and
    trained PlainMLP weights: the raw fidelity equals the JAX inversion of
    the cache, the generated fidelity is within 0.02 of the inversion of
    the JAX exact chain, and the samples came through the table walk."""
    cfg = _notebook(jcfg)
    n = cfg.data.num_qubits
    k_data, k_train, _ = jax.random.split(jax.random.key(0), 3)
    data = jpipe.generate_training_data(cfg, k_data, np.random.default_rng(0))
    cache = str(tmp_path / "data.npz")
    jpipe.save_data_cache(cache, data)
    sched = jmake_schedule("notebook", cfg.diffusion.num_timesteps)
    state = jtrain.create_state(k_train, jbuild_model(
        cfg.model, n, cfg.diffusion.num_timesteps), cfg.train, n)
    x, basis = jpipe.flatten_for_training(data.bits, data.basis_idx)
    for e in range(2):
        state, _ = jtrain._run_epoch(state, jax.random.fold_in(k_train, e), x,
                                     basis, sched, cfg.train.batch_size)
    ppath = str(tmp_path / "params.pt")
    torch.save(params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                       state.params)), ppath)
    dist = jdiff.sampler_distribution(jax.random.key(0), state.apply_fn,
                                      {"params": state.params}, n, sched)
    target = from_complex(data.target)
    fid_exact = float(jM.state_fidelity(
        target, jpauli.make_counts_inverter(n)(dist * SHOTS)))
    raw = float(jM.state_fidelity(target, jpauli.make_counts_inverter(
        n, data.basis_labels)(jmle.bits_to_counts(data.bits))))

    res = tpipe.run_experiment(_notebook(tcfg), seed=0, data_cache=cache,
                               params_load=ppath, device="cpu",
                               log_fn=lambda m: None)
    assert res["raw_fidelity"] == pytest.approx(raw, abs=1e-5)
    assert abs(res["fidelity"] - fid_exact) < 0.02
    assert tuple(res["samples"].shape) == (3, SHOTS, 1)
    assert {"tables", "walk"} <= set(res["timings"])
