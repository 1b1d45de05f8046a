"""``models.d3pm.embed``'s row lookup and its fixed-order backward
(``table_grad``) on the CPU: the lookup is ``nn.Embedding``'s bit for bit,
the gradient equals ``nn.Embedding``'s within float rounding and repeats bit
for bit, through both of its paths (the one-hot product over every row of a
small table, over the named rows of a large one) and across index blocks.
The card's repeat test is ``tests/test_torch_cuda.py::
test_embed_backward_repeats_bit_for_bit``."""

import pytest
import torch
from torch import nn

from ddqst_tpu_torch.models import d3pm

torch.set_num_threads(1)

# nn.Embedding's CPU backward adds in index order; table_grad in blocks of
# a matrix product: float32 roundings apart, relative to the largest entry.
GRAD_RTOL = 1e-5


def _grads(rows, m, e, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    table = nn.Embedding(rows, e)
    idx = torch.randint(0, rows, (m // 4, 4), generator=gen)
    grad_out = torch.randn((m // 4, 4, e), generator=gen).to(dtype)
    out = d3pm.embed(table, idx, dtype)
    assert out.dtype == dtype
    assert torch.equal(out, table(idx).to(dtype))
    out.backward(grad_out)
    got = table.weight.grad.clone()
    table.weight.grad = None
    table(idx).to(dtype).backward(grad_out)
    return got, table.weight.grad


@pytest.mark.parametrize("rows,m,e", [
    (2, 10240, 128),  # bit_emb at the shadow width
    (101, 1024, 16),  # time_emb, one CE batch
    (d3pm.ONE_HOT_ROWS, 512, 8),  # the largest table of the full product
    (d3pm.ONE_HOT_ROWS + 1, 512, 8),  # the smallest of the named rows
    (6561, 2048, 16),  # basis_emb at N = 8
])
def test_gradient_equals_nn_embedding_and_repeats(rows, m, e):
    got, want = _grads(rows, m, e)
    assert float((got - want).abs().max()) <= GRAD_RTOL * float(
        want.abs().max())
    again, _ = _grads(rows, m, e)
    assert torch.equal(got, again)


def test_bfloat16_rows_and_float32_gradient():
    got, want = _grads(3, 4096, 32, dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= GRAD_RTOL * float(
        want.abs().max())


@pytest.mark.parametrize("rows", [5, d3pm.ONE_HOT_ROWS + 3])
def test_index_blocks_sum_in_order(monkeypatch, rows):
    """A one-hot block smaller than the index count: the blocks' products
    add up to the one-block gradient (roundings apart), and unnamed rows
    get zero."""
    gen = torch.Generator().manual_seed(1)
    idx = torch.randint(0, rows - 1, (300,), generator=gen)  # last row unused
    grad = torch.randn((300, 6), generator=gen)
    whole = d3pm.table_grad(idx, grad, rows)
    monkeypatch.setattr(d3pm, "ONE_HOT_BLOCK_ELEMS", 7 * rows)
    blocks = d3pm.table_grad(idx, grad, rows)
    torch.testing.assert_close(blocks, whole, rtol=0, atol=1e-5)
    assert not blocks[rows - 1].any()
    want = torch.zeros(rows, 6).index_add_(0, idx, grad)
    torch.testing.assert_close(whole, want, rtol=0, atol=1e-5)


def test_gradcheck_in_float64():
    weight = torch.randn(7, 3, dtype=torch.float64, requires_grad=True)
    idx = torch.randint(0, 7, (5, 2))
    assert torch.autograd.gradcheck(
        lambda w: d3pm._Lookup.apply(w, idx), (weight,))
