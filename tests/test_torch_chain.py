"""Port parity: the sampler's exact output distribution (chain_distribution,
sampler_distribution, chain_distribution_all_bases) and its gradient against
ddqst_tpu on the same weights (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddqst_tpu.models import d3pm as jd3pm
from ddqst_tpu.ops import diffusion as jdiff
from ddqst_tpu.ops import schedules as jsched
from ddqst_tpu_torch.models import d3pm as td3pm, params_from_flax
from ddqst_tpu_torch.ops import diffusion as tdiff
from ddqst_tpu_torch.ops import pauli as tpauli
from ddqst_tpu_torch.ops import schedules as tsched

# The suite runs in several xdist workers; one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)

T = 10
WIDTH = dict(embed_dim=16, hidden_dim=32, num_blocks=2)
ATOL = 1e-5       # per entry of a distribution, against JAX
GRAD_RTOL = 1e-4  # per parameter tensor: max |Δ| over max |jax.grad|


def _models(n, seed=1):
    """A flax denoiser with seeded weights and the port's copy of it."""
    fm = jd3pm.ConditionalD3PM(num_qubits=n, num_bases=3**n, num_timesteps=T,
                               input_encoding="token", **WIDTH)
    params = fm.init(jax.random.key(seed), jnp.zeros((2, n), jnp.int8),
                     jnp.ones((2,), jnp.int32),
                     jnp.zeros((2,), jnp.int32))["params"]
    # Flax's zero-initialised layers would hide most of the network from the
    # chain and its gradient: give every tensor seeded values.
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.1 * rng.normal(size=a.shape)
                              .astype(np.float32)), params)
    tm = td3pm.ConditionalD3PM(n, 3**n, T, input_encoding="token", **WIDTH)
    tm.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return fm, params, tm.eval()


def _jfn(fm, params):
    return lambda x, t, b: fm.apply({"params": params}, x, t, b)


class _LabelStub(torch.nn.Module):
    """A denoiser conditioned on per-qubit basis labels ``[B, N]``, written
    from numpy weights; :func:`_label_stub_jax` is the same function."""

    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(torch.from_numpy(v)) for k, v in w.items()})

    def forward(self, x, t, labels):
        h = (x.float() @ self.w["x"] + self.w["t"][t]
             + self.w["lab"][labels].sum(1))
        return (torch.tanh(h) @ self.w["out"]).reshape(x.shape[0], -1, 2)


def _label_stub_jax(w):
    w = {k: jnp.asarray(v) for k, v in w.items()}

    def fn(x, t, labels):
        h = (x.astype(jnp.float32) @ w["x"] + w["t"][t]
             + w["lab"][labels].sum(1))
        return (jnp.tanh(h) @ w["out"]).reshape(x.shape[0], -1, 2)

    return fn


def _stub_weights(n, seed=0, hidden=24):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"x": f(n, hidden), "t": f(T + 1, hidden), "lab": f(3, hidden),
            "out": f(hidden, 2 * n)}


def _propagate(tables, num_bases, g, n):
    """float64 propagation of ``[T, B*g, n]`` p1 tables from the uniform
    start, with a dense ``[B, x, y]`` transition per step."""
    ys = ((np.arange(g)[:, None] >> np.arange(n)) & 1).astype(np.float64)
    dist = np.full((num_bases, g), 1.0 / g)
    for p1 in tables.astype(np.float64).reshape(-1, num_bases, g, n):
        f = (p1[:, :, None, :] * ys[None, None]
             + (1 - p1[:, :, None, :]) * (1 - ys[None, None]))
        dist = np.einsum("bx,bxy->by", dist, f.prod(-1))
        dist /= dist.sum(-1, keepdims=True)
    return dist


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("exact", [False, True])
def test_chain_distribution_matches_jax(n, exact):
    fm, params, tm = _models(n)
    ref = np.asarray(jdiff.chain_distribution(
        _jfn(fm, params), n, jsched.cosine_schedule(T), exact=exact))
    with torch.no_grad():
        out = tdiff.chain_distribution(tm, n, tsched.cosine_schedule(T),
                                       exact=exact)
    assert out.shape == (3**n, 2**n) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("exact", [False, True])
def test_chain_distribution_basis_idx_subset_matches_jax(exact):
    n = 3
    fm, params, tm = _models(n)
    idx = np.array([20, 3, 11, 26, 0], np.int32)
    ref = np.asarray(jdiff.chain_distribution(
        _jfn(fm, params), n, jsched.cosine_schedule(T), exact=exact,
        basis_idx=jnp.asarray(idx)))
    with torch.no_grad():
        sched = tsched.cosine_schedule(T)
        out = tdiff.chain_distribution(tm, n, sched, exact=exact,
                                       basis_idx=torch.from_numpy(idx))
        full = tdiff.chain_distribution(tm, n, sched, exact=exact)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    # Every basis' chain is independent: the subset is the rows of the whole.
    np.testing.assert_allclose(out.numpy(), full[idx].numpy(), atol=1e-6)


@pytest.mark.parametrize("exact", [False, True])
def test_chain_distribution_basis_labels_matches_jax(exact):
    """Label conditioning, with one stub denoiser in both frameworks."""
    n = 3
    w = _stub_weights(n)
    labels = tpauli.all_basis_labels(n)[[4, 17, 25, 9]]
    ref = np.asarray(jdiff.chain_distribution(
        _label_stub_jax(w), n, jsched.cosine_schedule(T), exact=exact,
        basis_labels=jnp.asarray(labels)))
    with torch.no_grad():
        out = tdiff.chain_distribution(
            _LabelStub(w), n, tsched.cosine_schedule(T), exact=exact,
            basis_labels=torch.from_numpy(labels))
    assert out.shape == (4, 8)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_basis_idx_and_basis_labels_are_exclusive():
    with pytest.raises(ValueError):
        tdiff.chain_distribution(
            _LabelStub(_stub_weights(2)), 2, tsched.cosine_schedule(T),
            basis_idx=torch.arange(2),
            basis_labels=torch.zeros((2, 2), dtype=torch.long))


@pytest.mark.parametrize("exact", [False, True])
def test_chain_gradient_matches_jax_grad(exact):
    """d CE(target, chain) / d params: params_from_flax carries the flax
    gradient tree to the port's parameter names."""
    n = 2
    fm, params, tm = _models(n)
    rng = np.random.default_rng(5)
    target = rng.dirichlet(np.ones(2**n), size=3**n).astype(np.float32)

    def jloss(p):
        dist = jdiff.chain_distribution(
            _jfn(fm, p), n, jsched.cosine_schedule(T), exact=exact)
        return -jnp.mean(jnp.sum(jnp.asarray(target)
                                 * jnp.log(jnp.maximum(dist, 1e-12)), -1))

    jval, jgrad = jax.value_and_grad(jloss)(params)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrad))

    dist = tdiff.chain_distribution(tm, n, tsched.cosine_schedule(T),
                                    exact=exact)
    loss = -(torch.from_numpy(target)
             * torch.log(dist.clamp_min(1e-12))).sum(-1).mean()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jval), rel=1e-5)
    grads = {k: p.grad for k, p in tm.named_parameters()}
    assert grads.keys() == ref.keys()
    for k, g in grads.items():
        scale = float(ref[k].abs().max())
        assert scale > 0, k
        assert float((g - ref[k]).abs().max()) <= GRAD_RTOL * scale, k


def test_checkpointed_equals_uncheckpointed():
    n = 2
    _, _, tm = _models(n)
    sched = tsched.cosine_schedule(T)
    out = {}
    for ckpt in (True, False):
        tm.zero_grad()
        dist = tdiff.chain_distribution(tm, n, sched, exact=False,
                                        checkpoint=ckpt)
        dist[:, 0].log().sum().backward()
        out[ckpt] = (dist.detach(), [p.grad.clone() for p in tm.parameters()])
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=1e-7)
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("exact", [False, True])
def test_chain_equals_propagation_of_grid_tables(exact):
    """The chain and the samplers share one posterior: propagating the
    sampler's own grid tables gives chain_distribution."""
    n = 3
    _, _, tm = _models(n)
    sched = tsched.cosine_schedule(T)
    tables = tdiff.grid_p1_tables(tm, n, sched, exact=exact).numpy()
    with torch.no_grad():
        out = tdiff.chain_distribution(tm, n, sched, exact=exact)
    np.testing.assert_allclose(out.numpy(), _propagate(tables, 27, 8, n),
                               atol=ATOL)


def test_sampler_distribution_matches_jax_without_gradients():
    n = 2
    fm, params, tm = _models(n)
    ref = np.asarray(jdiff.sampler_distribution(
        jax.random.key(0), fm.apply, {"params": params}, n,
        jsched.cosine_schedule(T)))
    out = tdiff.sampler_distribution(tm, n, tsched.cosine_schedule(T))
    assert not out.requires_grad
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("max_rows", [1 << 14, 40, 1])
def test_chain_distribution_all_bases_matches_jax(max_rows):
    """Chunked over bases (max_rows // 2^N a chunk, at least one) it equals
    JAX's, whatever the chunk."""
    n = 3
    fm, params, tm = _models(n)
    ref = np.asarray(jdiff.chain_distribution_all_bases(
        fm.apply, params, n, jsched.cosine_schedule(T), exact=False))
    out = tdiff.chain_distribution_all_bases(
        tm, n, tsched.cosine_schedule(T), exact=False, max_rows=max_rows)
    assert out.shape == (27, 8) and not out.requires_grad
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_chain_distribution_all_bases_with_labels():
    n = 3
    w = _stub_weights(n, seed=2)
    labels = tpauli.all_basis_labels(n)[::2]  # 14 rows
    sched = tsched.cosine_schedule(T)
    out = tdiff.chain_distribution_all_bases(
        _LabelStub(w), n, sched, exact=False,
        basis_labels=torch.from_numpy(labels), max_rows=5 * 8)
    ref = np.asarray(jdiff.chain_distribution(
        _label_stub_jax(w), n, jsched.cosine_schedule(T), exact=False,
        basis_labels=jnp.asarray(labels)))
    assert out.shape == (14, 8)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
