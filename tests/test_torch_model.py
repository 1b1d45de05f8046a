"""Port parity: the FiLM denoiser against the flax model on the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddqst_tpu.config import get_preset as jax_preset
from ddqst_tpu.models import d3pm as jd3pm
from ddqst_tpu_torch.config import ModelConfig, get_preset
from ddqst_tpu_torch.models import build_model, d3pm, params_from_flax

# The suite runs in several xdist workers; one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)

N, T = 3, 20


def _flax_model(encoding, embed=16, hidden=32, blocks=2):
    return jd3pm.ConditionalD3PM(
        num_qubits=N, num_bases=3**N, num_timesteps=T, embed_dim=embed,
        hidden_dim=hidden, num_blocks=blocks, input_encoding=encoding,
    )


def _inputs(rng, b=64):
    x = rng.integers(0, 2, (b, N)).astype(np.int8)
    t = rng.integers(0, T + 1, b).astype(np.int32)
    basis = rng.integers(0, 3**N, b).astype(np.int32)
    return x, t, basis


@pytest.mark.parametrize("encoding", ["token", "float"])
def test_forward_matches_flax_on_converted_weights(encoding):
    rng = np.random.default_rng(0)
    fm = _flax_model(encoding)
    x, t, basis = _inputs(rng)
    params = fm.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(t),
                     jnp.asarray(basis))["params"]
    ref = np.asarray(fm.apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(t), jnp.asarray(basis)))
    tm = d3pm.ConditionalD3PM(N, 3**N, T, embed_dim=16, hidden_dim=32,
                              num_blocks=2, input_encoding=encoding)
    tm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t),
                 torch.from_numpy(basis)).numpy()
    assert out.shape == (64, N, 2) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_rqc_width_parameter_count_matches_flax():
    jcfg = jax_preset("rqc")
    fm = jd3pm.build_model(jcfg.model, jcfg.data.num_qubits,
                           jcfg.diffusion.num_timesteps)
    z = jnp.zeros((2, jcfg.data.num_qubits), jnp.int8)
    params = fm.init(jax.random.key(0), z, jnp.ones((2,), jnp.int32),
                     jnp.zeros((2,), jnp.int32))["params"]
    n_flax = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(params))
    cfg = get_preset("rqc")
    tm = build_model(cfg.model, cfg.data.num_qubits, cfg.diffusion.num_timesteps)
    assert sum(p.numel() for p in tm.parameters()) == n_flax
    assert 3.0e6 < n_flax < 3.8e6  # "about 3.4 M parameters"


def test_init_follows_flax_defaults():
    """lecun-normal Linear weights (truncated at 2 std) with zero bias, and
    N(0, 1/E) embeddings, drawn from the given generator."""
    tm = d3pm.ConditionalD3PM(N, 3**N, 100, embed_dim=128, hidden_dim=512,
                              num_blocks=1, input_encoding="token")
    d3pm.init_params_(tm, torch.Generator().manual_seed(0))
    w = tm.blocks[0].fc1.weight.detach()
    assert abs(float(w.std()) - 512**-0.5) < 2e-3
    assert float(w.abs().max()) <= 2 * 512**-0.5 / d3pm._TRUNC_STD + 1e-6
    assert float(tm.blocks[0].fc1.bias.detach().abs().max()) == 0.0
    assert abs(float(tm.time_emb.weight.detach().std()) - 128**-0.5) < 5e-3
    a = [p.clone() for p in tm.parameters()]
    d3pm.init_params_(tm, torch.Generator().manual_seed(0))
    assert all(torch.equal(p, q) for p, q in zip(a, tm.parameters()))


@pytest.mark.parametrize("field,value", [("arch", "transformer"),
                                         ("arch", "plain_mlp"),
                                         ("dtype", "bfloat16")])
def test_unported_model_options_raise(field, value):
    """Every model option is ported now; each case builds its model."""
    from ddqst_tpu_torch.models import PlainMLP, TransformerDenoiser

    cfg = ModelConfig(**{field: value})
    model = build_model(cfg, N, T)
    if value == "transformer":  # the shadow route's denoiser
        assert isinstance(model, TransformerDenoiser)
    elif value == "plain_mlp":  # the notebook presets' denoiser
        assert isinstance(model, PlainMLP)
    else:  # bf16 compute, float32 parameters
        assert model.compute_dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in model.parameters())
