"""Port parity: the shadow route's transformer denoiser against the flax
model on the same weights, its parameter count, its label helpers and its
initialisation (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddqst_tpu.config import get_preset as jax_preset
from ddqst_tpu.models import d3pm as jd3pm
from ddqst_tpu.models import transformer as jt
from ddqst_tpu_torch import train as ttrain
from ddqst_tpu_torch.config import TrainConfig, get_preset
from ddqst_tpu_torch.models import build_model, params_from_flax
from ddqst_tpu_torch.models import transformer as tt
from ddqst_tpu_torch.ops import schedules as tsched

# The suite runs in several xdist workers; one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)

T = 12
ATOL = 1e-5  # logits against flax


def _flax_and_port(n, embed, blocks, heads, seed=1):
    """A flax transformer with seeded weights (every tensor, LayerNorms
    included, moved off its initial value) and the port's copy of it."""
    fm = jt.TransformerDenoiser(num_qubits=n, num_timesteps=T, embed_dim=embed,
                                hidden_dim=2 * embed, num_blocks=blocks,
                                num_heads=heads)
    params = fm.init(jax.random.key(seed), jnp.zeros((2, n), jnp.int8),
                     jnp.ones((2,), jnp.int32),
                     jnp.zeros((2,), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.1 * rng.normal(size=a.shape)
                              .astype(np.float32)), params)
    tm = tt.TransformerDenoiser(n, T, embed_dim=embed, hidden_dim=2 * embed,
                                num_blocks=blocks, num_heads=heads)
    tm.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return fm, params, tm.eval()


@pytest.mark.parametrize("labels", [False, True], ids=["index", "labels"])
@pytest.mark.parametrize("n,embed,blocks,heads", [(3, 16, 1, 2),
                                                  (5, 32, 2, 4)])
def test_logits_match_flax_on_converted_weights(n, embed, blocks, heads,
                                                labels):
    fm, params, tm = _flax_and_port(n, embed, blocks, heads)
    rng = np.random.default_rng(n)
    x = rng.integers(0, 2, (48, n)).astype(np.int8)
    t = rng.integers(0, T + 1, 48).astype(np.int32)
    basis = (rng.integers(0, 3, (48, n)) if labels
             else rng.integers(0, 3**n, 48)).astype(np.int32)
    ref = np.asarray(fm.apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(t), jnp.asarray(basis)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t),
                 torch.from_numpy(basis)).numpy()
    assert out.shape == (48, n, 2) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=ATOL)


def test_preset_width_parameter_count_matches_flax():
    jcfg = jax_preset("shadow_transformer")
    n = jcfg.data.num_qubits
    fm = jd3pm.build_model(jcfg.model, n, jcfg.diffusion.num_timesteps)
    params = fm.init(jax.random.key(0), jnp.zeros((2, n), jnp.int8),
                     jnp.ones((2,), jnp.int32),
                     jnp.zeros((2,), jnp.int32))["params"]
    n_flax = sum(int(np.prod(p.shape))
                 for p in jax.tree_util.tree_leaves(params))
    cfg = get_preset("shadow_transformer")
    tm = build_model(cfg.model, n, cfg.diffusion.num_timesteps)
    assert isinstance(tm, tt.TransformerDenoiser)
    assert sum(p.numel() for p in tm.parameters()) == n_flax
    # The converted tree fills every parameter of the port's model.
    sd = params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    assert sd.keys() == tm.state_dict().keys()
    assert all(sd[k].shape == v.shape for k, v in tm.state_dict().items())


@pytest.mark.parametrize("n", [1, 4, 10])
def test_basis_idx_to_labels_round_trip_matches_jax(n):
    idx = np.random.default_rng(n).integers(0, 3**n, 200)
    ref = np.asarray(jt.basis_idx_to_labels(jnp.asarray(idx), n))
    got = tt.basis_idx_to_labels(torch.from_numpy(idx), n)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tt.labels_to_basis_idx(got).numpy(), idx)
    np.testing.assert_array_equal(
        np.asarray(jt.labels_to_basis_idx(jnp.asarray(ref))), idx)


def test_fit_initialises_every_parameter_from_its_generator():
    """Two models built under different global seeds and initialised by
    ``fit`` (no epoch) from one generator seed are equal: no parameter keeps
    the constructor's draw. ``pos_emb`` is N(0, 0.02), LayerNorms 1 / 0."""
    cfg = get_preset("shadow_transformer")
    models = []
    for global_seed in (0, 1):
        torch.manual_seed(global_seed)
        m = build_model(cfg.model, 10, 100)
        with torch.no_grad():  # nothing may survive the re-draw
            for p in m.parameters():
                p.add_(1.0)
        bits = torch.zeros((8, 10), dtype=torch.int8)
        ttrain.fit(torch.Generator().manual_seed(7), m, bits,
                   torch.zeros((8, 10), dtype=torch.int64),
                   TrainConfig(num_epochs=0), tsched.cosine_schedule(100),
                   device="cpu")
        models.append(m)
    a, b = ({k: p.detach() for k, p in m.named_parameters()} for m in models)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert abs(float(a["pos_emb"].std()) - 0.02) < 0.002
    assert float(a["pos_emb"].mean().abs()) < 0.002
    for name in ("ln_f", "blocks.0.ln1", "blocks.3.ln2"):
        assert torch.equal(a[f"{name}.weight"], torch.ones(128))
        assert torch.equal(a[f"{name}.bias"], torch.zeros(128))
    assert abs(float(a["bit_emb.weight"].std()) - 128**-0.5) < 0.02


def test_layer_norm_epsilon_is_flax_s():
    """1e-6, not torch's 1e-5: on a token whose features barely vary (a
    variance of 2e-5, about a zero mean, where flax's E[x²] - E[x]² keeps
    its digits) the two differ by 19%."""
    import flax.linen as fnn

    fm, params, tm = _flax_and_port(3, 16, 1, 2)
    h = 1e-3 * (np.arange(16, dtype=np.float32)[None, None] - 7.5)
    want = np.asarray(fnn.LayerNorm().apply({"params": params["ln_f"]},
                                            jnp.asarray(h)))
    with torch.no_grad():
        got = tm.ln_f(torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_transformer_takes_no_circuit_conditioning():
    cfg = get_preset("shadow_transformer")
    with pytest.raises(ValueError, match="circuit"):
        build_model(cfg.model, 4, 10, num_circuits=3)
