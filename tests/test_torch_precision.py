"""``ddqst_tpu_torch.ops.precision``: the TPU's default matmul precision
(bfloat16-input products, float32 accumulation), emulated, on the CPU.

The reference is the explicit rounding: float64 products of operands
rounded to bfloat16. ``ddqst_tpu`` cannot serve here, since on the CPU
``jax.default_matmul_precision`` leaves a float32 product exactly as it is
at ``"highest"``. (a0) ``round_bf16`` is a round to nearest even (ties,
the largest finite value, infinities, NaN). (a) The bf16-pass linear layer, forward and both backward
products, and the chain's batched product, forward and backward, equal the
rounded float64 products within float32 accumulation error (1e-5 of the
largest entry). (b) At the ``rqc`` width (one block) the FiLM model's
logits, and one ``chain_distribution`` at N = 3, within the context equal a
float64 recomputation that rounds every product's operands: the mean
absolute gap within 1e-4 of the mean magnitude, where plain float32 lies
more than ten times that away. The gap is held on the mean, not entry by
entry: the port rounds float32 activations, the recomputation float64 ones,
so an activation within float32 noise of a rounding midpoint rounds the
other way, and such a flip moves a few entries by up to 1e-3 of the
largest (more with every block: a float32 ulp on the weights moves a
four-block model's bf16-pass logits by 3e-3).
(c) The context restores float32 on exit, also after an exception,
refuses an unknown mode and the transformer. (d) Outside it ``dense`` and
``chain_distribution`` never reach the emulation and are ``F.linear``'s /
the plain einsum's, bit for bit.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ddqst_tpu_torch.config import get_preset
from ddqst_tpu_torch.models import d3pm
from ddqst_tpu_torch.ops import diffusion as diff
from ddqst_tpu_torch.ops import precision, schedules

torch.set_num_threads(2)

UNIT_RTOL = 1e-5  # float32 accumulation against float64, of the max entry
MODEL_RTOL = 1e-4  # a whole model's mean gap, of its mean magnitude


def r64(a: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 (through float32, as the port holds it) and
    return float64."""
    return a.float().to(torch.bfloat16).double()


def _close(got, want, rtol):
    want = want.double()
    scale = want.abs().max().item()
    err = (got.double() - want).abs().max().item()
    assert err <= rtol * scale, (err, scale)
    return err / scale


def _mean_gap(got, want):
    """Mean absolute gap over mean magnitude."""
    want = want.double()
    return ((got.double() - want).abs().mean() / want.abs().mean()).item()


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def test_round_bf16_is_round_to_nearest_even():
    """Random values, exact ties of both parities, the largest finite
    value, infinities and NaN: the same bits as a round to nearest even
    written in numpy on the bits (the TPU's round)."""
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2**32, 100_000, dtype=np.uint64).astype(np.uint32)
    u[:1000] = (u[:1000] & 0xFFFF0000) | 0x8000  # exact ties
    u[1000:1004] = [0x7F7FFFFF, 0x7F800000, 0xFF800000, 0x7FC00000]
    a = u.view(np.float32)
    want = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    got = precision.round_bf16(torch.from_numpy(a)).numpy()
    finite = ~np.isnan(a)
    np.testing.assert_array_equal(got.view(np.uint32)[finite], want[finite])
    assert np.isnan(got[~finite]).all()


@pytest.mark.parametrize("lead", [(64,), (4, 16)])
def test_linear_forward_and_backward_are_bf16_pass_products(lead):
    rng = np.random.default_rng(1)
    x = _randn(rng, *lead, 256).requires_grad_()
    w = (_randn(rng, 128, 256) / 16).requires_grad_()
    b = _randn(rng, 128).requires_grad_()
    g = _randn(rng, *lead, 128)
    y = precision.linear(x, w, b)
    y.backward(g)
    _close(y, r64(x) @ r64(w).T + b.double(), UNIT_RTOL)
    _close(x.grad, r64(g) @ r64(w), UNIT_RTOL)
    _close(w.grad, r64(g).reshape(-1, 128).T @ r64(x).reshape(-1, 256),
           UNIT_RTOL)
    # The bias gradient is a float32 sum of the unrounded gradient.
    _close(b.grad, g.double().reshape(-1, 128).sum(0), UNIT_RTOL)
    # Plain float32 is not within the tolerance: the rounding is there.
    plain = F.linear(x, w, b).detach()
    assert (plain - y.detach()).abs().max() > 100 * UNIT_RTOL * y.abs().max()


def test_chain_product_forward_and_backward_are_bf16_pass_products():
    rng = np.random.default_rng(2)
    p = torch.from_numpy(rng.dirichlet(np.ones(64), 6).astype(np.float32))
    t = torch.from_numpy(rng.uniform(0, 1, (6, 64, 64)).astype(np.float32))
    p.requires_grad_()
    t.requires_grad_()
    g = _randn(rng, 6, 64)
    y = precision.chain_product(p, t)
    y.backward(g)
    _close(y, torch.einsum("bx,bxy->by", r64(p), r64(t)), UNIT_RTOL)
    _close(p.grad, torch.einsum("by,bxy->bx", r64(g), r64(t)), UNIT_RTOL)
    _close(t.grad, torch.einsum("bx,by->bxy", r64(p), r64(g)), UNIT_RTOL)
    plain = torch.einsum("bx,bxy->by", p, t).detach()
    assert (plain - y.detach()).abs().max() > 100 * UNIT_RTOL * y.abs().max()


def _rqc_model(n: int, t_steps: int,
               num_blocks: int = 1) -> d3pm.ConditionalD3PM:
    """The ``rqc`` preset's widths and encoding, ``num_blocks`` blocks."""
    m = get_preset("rqc").model
    torch.manual_seed(0)
    return d3pm.ConditionalD3PM(
        num_qubits=n, num_bases=3**n, num_timesteps=t_steps,
        embed_dim=m.embed_dim, hidden_dim=m.hidden_dim,
        num_blocks=num_blocks, input_encoding=m.input_encoding)


def _ref_logits(model, x, t, b, rnd=r64):
    """The FiLM model's forward in float64, every product's operands
    passed through ``rnd``."""
    p = {k: v.double() for k, v in model.state_dict().items()}

    def lin(name, h):
        return rnd(h) @ rnd(p[f"{name}.weight"]).T + p[f"{name}.bias"]

    h = lin("input_proj", p["x_emb.weight"][x].reshape(x.shape[0], -1))
    cond = torch.cat([p["time_emb.weight"][t], p["basis_emb.weight"][b]], -1)
    for i in range(len(model.blocks)):
        gamma, beta = lin(f"blocks.{i}.film", cond).chunk(2, dim=-1)
        u = h * (1.0 + gamma) + beta
        u = lin(f"blocks.{i}.fc2", F.silu(lin(f"blocks.{i}.fc1", u)))
        h = F.silu(h + u)
    return lin("output_head", h).reshape(x.shape[0], -1, 2)


def test_film_logits_at_the_rqc_width_round_every_product():
    n, t_steps = 3, 100
    model = _rqc_model(n, t_steps)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 2, (64, n)))
    t = torch.from_numpy(rng.integers(1, t_steps + 1, 64))
    b = torch.from_numpy(rng.integers(0, 3**n, 64))
    with precision.default_matmul_precision("bfloat16"):
        got = model(x, t, b)
    want = _ref_logits(model, x, t, b)
    assert _mean_gap(got, want) <= MODEL_RTOL
    unrounded = _ref_logits(model, x, t, b, rnd=lambda a: a)
    _close(model(x, t, b), unrounded, UNIT_RTOL)
    assert _mean_gap(got, unrounded) > 10 * MODEL_RTOL


def test_chain_distribution_at_small_n_rounds_every_product():
    n, t_steps = 3, 10
    model = _rqc_model(n, t_steps)
    sched = schedules.make_schedule(
        get_preset("rqc").diffusion.schedule, t_steps)
    bidx = torch.tensor([0, 5, 13, 26])
    with precision.default_matmul_precision("bfloat16"):
        got = diff.chain_distribution(model, n, sched, basis_idx=bidx)
    plain = diff.chain_distribution(model, n, sched, basis_idx=bidx)

    g = 2**n
    x_enum = (torch.arange(g)[:, None] >> torch.arange(n)) & 1
    grid_x = x_enum.repeat(len(bidx), 1)
    grid_b = bidx.repeat_interleave(g)
    y_bits = x_enum.double()
    exact = diff._resolve_exact(sched, None)
    dist = torch.full((len(bidx), g), 1.0 / g, dtype=torch.float64)
    for t in range(t_steps, 0, -1):
        logits = _ref_logits(model, grid_x, torch.full((len(grid_x),), t),
                             grid_b)
        p1 = diff._grid_p1_table(logits, grid_x, t, sched, exact).double()
        p1 = p1.reshape(len(bidx), g, n)
        trans = torch.ones(len(bidx), g, g, dtype=torch.float64)
        for q in range(n):
            pq, yq = p1[:, :, None, q], y_bits[None, None, :, q]
            trans = trans * (pq * yq + (1.0 - pq) * (1.0 - yq))
        new = torch.einsum("bx,bxy->by", r64(dist), r64(trans))
        dist = new / new.sum(-1, keepdim=True)
    assert _mean_gap(got, dist) <= MODEL_RTOL
    assert _mean_gap(plain, dist) > 10 * MODEL_RTOL


def test_context_restores_float32_and_refuses_what_it_cannot_run():
    assert precision.current() == "float32" and not precision.active()
    with precision.default_matmul_precision("bfloat16"):
        assert precision.active()
        with precision.default_matmul_precision("float32"):
            assert precision.current() == "float32"
        assert precision.active()
    assert precision.current() == "float32"
    with pytest.raises(RuntimeError, match="inside"):
        with precision.default_matmul_precision("bfloat16"):
            raise RuntimeError("inside")
    assert precision.current() == "float32"
    with pytest.raises(ValueError, match="unknown matmul precision"):
        with precision.default_matmul_precision("tensorfloat32"):
            pass
    assert precision.current() == "float32"

    from ddqst_tpu_torch.models.transformer import TransformerDenoiser

    tr = TransformerDenoiser(num_qubits=3, num_timesteps=4, embed_dim=8,
                             hidden_dim=16, num_blocks=1, num_heads=2)
    x = torch.zeros(2, 3, dtype=torch.long)
    t = torch.ones(2, dtype=torch.long)
    b = torch.zeros(2, dtype=torch.long)
    with precision.default_matmul_precision("bfloat16"):
        with pytest.raises(ValueError, match="the transformer"):
            tr(x, t, b)
    assert tr(x, t, b).shape == (2, 3, 2)


def test_outside_the_context_nothing_reaches_the_emulation(monkeypatch):
    calls = []

    def counted(name):
        own = getattr(precision, name)

        def stand_in(*a):
            calls.append(name)
            return own(*a)
        return stand_in

    monkeypatch.setattr(precision, "linear", counted("linear"))
    monkeypatch.setattr(precision, "chain_product", counted("chain_product"))
    n, t_steps = 3, 4
    model = _rqc_model(n, t_steps, num_blocks=4)
    sched = schedules.make_schedule(
        get_preset("rqc").diffusion.schedule, t_steps)
    rng = np.random.default_rng(4)
    x = _randn(rng, 32, 512)
    layer = model.blocks[0].fc1
    assert torch.equal(d3pm.dense(layer, x, torch.float32),
                       F.linear(x, layer.weight, layer.bias))
    dist = diff.chain_distribution(model, n, sched, basis_idx=torch.arange(5))
    dist.sum().backward()
    assert calls == []
    with precision.default_matmul_precision("bfloat16"):
        d3pm.dense(layer, x, torch.float32)
        diff.chain_distribution(model, n, sched, basis_idx=torch.arange(5))
    # 1 + T x (4 blocks x 3 + 2) dense calls, T chain products.
    assert calls.count("linear") == 1 + t_steps * 14
    assert calls.count("chain_product") == t_steps
    # A bfloat16 model keeps flax's bf16 compute inside the context.
    calls.clear()
    with precision.default_matmul_precision("bfloat16"):
        d3pm.dense(layer, x, torch.bfloat16)
    assert calls == []
