"""Port parity: the maximum-likelihood estimators (dense, factored, blocked)
and factored_born_probs against ddqst_tpu on the same counts (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddqst_tpu.ops import metrics as jM
from ddqst_tpu.ops import mle as jmle
from ddqst_tpu.ops import pauli as jpauli
from ddqst_tpu.ops.complexlib import from_complex, to_complex
from ddqst_tpu.qsim import measure as jmeasure
from ddqst_tpu.qsim import noise as jnoise
from ddqst_tpu.qsim import states as jstates
from ddqst_tpu_torch.ops import metrics as tM
from ddqst_tpu_torch.ops import mle as tmle
from ddqst_tpu_torch.ops import pauli as tpauli
from ddqst_tpu_torch.qsim import measure as tmeasure
from ddqst_tpu_torch.qsim import noise as tnoise

# The suite runs in several xdist workers; one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)

RHO_ATOL = 2e-4  # per entry of ρ, against JAX's solve of the same counts
FID_ATOL = 1e-4  # fidelity with the true state, against JAX's
PROB_ATOL = 1e-5


def _psi(n, seed=3):
    return jstates.circuit_statevector(
        jstates.prep_circuit("rqc", n, 4, np.random.default_rng(seed)))


def _counts(psi, n, labels, shots, readout_p=0.0, seed=0):
    """Multinomial counts of ``psi`` in ``labels`` through a readout flip."""
    probs = jmeasure.batched_probs_pure(
        from_complex(psi[None]),
        from_complex(jmeasure.rotation_unitaries(labels)))[0]
    probs = np.asarray(jnoise.apply_readout_to_probs(probs, n, readout_p),
                       np.float64)
    probs /= probs.sum(-1, keepdims=True)
    rng = np.random.default_rng(seed)
    return np.stack([rng.multinomial(shots, p) for p in probs]).astype(
        np.float32)


def _both(n, counts, psi, **kw):
    """(port ρ, JAX ρ, port fidelity, JAX fidelity) of one solve."""
    ref = jmle.make_mle(n, **kw)(jnp.asarray(counts))
    out = tmle.make_mle(n, **kw)(torch.from_numpy(counts))
    assert out.dtype == torch.complex64 and out.shape == (2**n, 2**n)
    return (out.numpy(), to_complex(ref),
            float(tM.state_fidelity(torch.from_numpy(psi), out)),
            float(jM.state_fidelity(from_complex(psi), ref)))


@pytest.mark.parametrize("readout_p", [0.0, 0.02])
def test_povm_elements_match_jax(readout_p):
    labels = tpauli.all_basis_labels(2)
    out = tmle._povm_elements(2, labels, readout_p)
    ref = jmle._povm_elements(2, labels, readout_p)
    assert out.shape == (9 * 4, 4, 4) and out.dtype == np.complex64
    np.testing.assert_allclose(out, ref, atol=1e-6)
    # Each basis' elements resolve the identity, readout folded in or not.
    np.testing.assert_allclose(out.reshape(9, 4, 4, 4).sum(1),
                               np.broadcast_to(np.eye(4), (9, 4, 4)),
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["dense", "factored"])
@pytest.mark.parametrize("readout_p", [0.0, 0.02])
def test_make_mle_matches_jax(impl, readout_p):
    n = 3
    psi = _psi(n)
    counts = _counts(psi, n, tpauli.all_basis_labels(n), 2000, readout_p)
    out, ref, fid, jfid = _both(n, counts, psi, readout_p=readout_p, impl=impl)
    np.testing.assert_allclose(out, ref, atol=RHO_ATOL)
    assert fid == pytest.approx(jfid, abs=FID_ATOL)
    assert abs(np.trace(out) - 1) < 1e-5
    np.testing.assert_allclose(out, out.conj().T, atol=1e-6)
    assert np.linalg.eigvalsh(out).min() > -1e-6


@pytest.mark.parametrize("n,readout_p", [(4, 0.0), (3, 0.03)])
def test_make_mle_blocked_matches_jax(n, readout_p, monkeypatch):
    """The block threshold lowered in both packages: 81 (27) rows in blocks
    of 4, the last one ragged."""
    d = 2**n
    psi = _psi(n)
    counts = _counts(psi, n, tpauli.all_basis_labels(n), 3000, readout_p)
    single = tmle.make_mle(n, readout_p=readout_p, impl="factored")(
        torch.from_numpy(counts)).numpy()
    monkeypatch.setattr(tmle, "_FACTORED_BLOCK_ELEMS", 4 * d * d)
    monkeypatch.setattr(jmle, "_FACTORED_BLOCK_ELEMS", 4 * d * d)
    out, ref, fid, jfid = _both(n, counts, psi, readout_p=readout_p,
                                impl="factored")
    np.testing.assert_allclose(out, ref, atol=RHO_ATOL)
    assert fid == pytest.approx(jfid, abs=FID_ATOL)
    # Blocking changes the order of the sums, not the estimator.
    np.testing.assert_allclose(out, single, atol=2e-5)


def test_make_mle_auto_is_factored_from_five_qubits(monkeypatch):
    """``impl='auto'``: dense to N=4, factored from N=5 (here on 12 of the
    243 bases, a few iterations, against JAX)."""
    called = []
    real = tmle._rotate
    monkeypatch.setattr(tmle, "_rotate",
                        lambda *a: called.append(1) or real(*a))
    n = 5
    psi = _psi(n)
    labels = tpauli.all_basis_labels(n)[::21]
    counts = _counts(psi, n, labels, 500)
    out, ref, _, _ = _both(n, counts, psi, basis_labels=labels, iterations=8)
    assert called
    np.testing.assert_allclose(out, ref, atol=RHO_ATOL)
    called.clear()
    tmle.make_mle(2, iterations=2)(torch.ones(9, 4))
    assert not called


@pytest.mark.parametrize("impl", ["dense", "factored"])
def test_make_mle_on_a_basis_subset_matches_jax(impl):
    n = 3
    psi = _psi(n, seed=8)
    labels = tpauli.all_basis_labels(n)[[0, 4, 8, 13, 14, 20, 22, 25, 26, 11]]
    counts = _counts(psi, n, labels, 1500, readout_p=0.015)
    out, ref, fid, jfid = _both(n, counts, psi, basis_labels=labels,
                                readout_p=0.015, impl=impl)
    np.testing.assert_allclose(out, ref, atol=RHO_ATOL)
    assert fid == pytest.approx(jfid, abs=FID_ATOL)


def test_mle_stop_does_not_depend_on_the_flag_cadence():
    """ρ is frozen on the device at the stopping iteration: reading the
    flag every 1, 7 or 64 iterations returns the same ρ and count."""
    n = 2
    psi = _psi(n)
    counts = torch.from_numpy(
        _counts(psi, n, tpauli.all_basis_labels(n), 800, 0.02))
    runs = []
    for every in (1, 7, 64):
        info = {}
        rho = tmle.make_mle(n, readout_p=0.02, iters_per_call=every)(counts,
                                                                     info)
        runs.append((rho, info["iterations"]))
    assert 1 < runs[0][1] < 4000
    for rho, iters in runs[1:]:
        assert iters == runs[0][1]
        assert torch.equal(rho, runs[0][0])
    # The cap holds too.
    info = {}
    tmle.make_mle(n, iterations=5)(counts, info)
    assert info["iterations"] == 5


def test_mle_takes_frequencies_as_well_as_counts():
    n = 2
    counts = torch.from_numpy(
        _counts(_psi(n), n, tpauli.all_basis_labels(n), 640))
    rec = tmle.make_mle(n)
    np.testing.assert_allclose(rec(counts / 640).numpy(), rec(counts).numpy(),
                               atol=1e-6)


def test_mle_recovers_ghz3_through_the_readout_povm():
    n, p = 3, 0.02
    psi = np.zeros(8, np.complex64)
    psi[0] = psi[7] = 2**-0.5
    probs = jmeasure.batched_probs_pure(
        from_complex(psi[None]),
        from_complex(jmeasure.rotation_unitaries(jpauli.all_basis_labels(n))))
    noisy = np.asarray(jnoise.apply_readout_to_probs(probs[0], n, p))
    rho = tmle.make_mle(n, readout_p=p)(torch.from_numpy(noisy * 1e5))
    assert float(tM.state_fidelity(torch.from_numpy(psi), rho)) > 0.999
    # Without the channel in the POVM the same counts score visibly lower.
    plain = tmle.make_mle(n)(torch.from_numpy(noisy * 1e5))
    assert float(tM.state_fidelity(torch.from_numpy(psi), plain)) < 0.97


def test_unknown_impl_raises():
    with pytest.raises(ValueError):
        tmle.make_mle(2, impl="sparse")


def _random_rho(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(2**n, 2**n)) + 1j * rng.normal(size=(2**n, 2**n))
    rho = a @ a.conj().T
    return (rho / np.trace(rho).real).astype(np.complex64)


@pytest.mark.parametrize("block_elems", [None, 4 * 64])
def test_factored_born_probs_match_jax(block_elems, monkeypatch):
    n = 3
    if block_elems:
        monkeypatch.setattr(tmle, "_FACTORED_BLOCK_ELEMS", block_elems)
        monkeypatch.setattr(jmle, "_FACTORED_BLOCK_ELEMS", block_elems)
    rho = _random_rho(n)
    labels = tpauli.all_basis_labels(n)
    out = tmle.factored_born_probs(torch.from_numpy(rho), labels)
    ref = jmle.factored_born_probs(from_complex(rho), labels)
    assert out.shape == (27, 8) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=PROB_ATOL)
    dense = tmeasure.batched_probs_mixed(
        torch.from_numpy(rho)[None],
        torch.from_numpy(tmeasure.rotation_unitaries(labels)))[0]
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=PROB_ATOL)


def test_kron_block_and_rotate_equal_the_dense_rotations():
    n = 3
    labels = tpauli.all_basis_labels(n)[[5, 13, 26, 7]]
    f = torch.from_numpy(tmle._rot1(labels))
    dense = torch.from_numpy(tmeasure.rotation_unitaries(labels))
    torch.testing.assert_close(tmle._kron_block(f), dense, rtol=0, atol=1e-6)
    rho = torch.from_numpy(_random_rho(n, seed=1))
    got = tmle._rotate(rho.expand(4, 8, 8), f, n)
    torch.testing.assert_close(got, dense @ rho @ dense.mH, rtol=0, atol=1e-6)
    # One factor from the left, one from the right: qubit 0 is the LSB.
    q = 1
    u = f[:, q]
    eye = torch.eye(2, dtype=torch.complex64).expand(4, 2, 2)
    full = tmle._kron_block(torch.stack(
        [u if k == q else eye for k in range(n)], dim=1))
    t = rho.expand(4, 8, 8)
    torch.testing.assert_close(tmle._apply_left(t, u, q, n), full @ t,
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(tmle._apply_right_dag(t, u, q, n), t @ full.mH,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("transpose", [False, True])
def test_confuse_probs_equals_the_dense_confusion_matrix(transpose):
    n, p = 3, 0.04
    m2 = torch.tensor([[1 - p, p], [p, 1 - p]])
    if transpose:
        m2 = m2.T
    rows = torch.from_numpy(
        np.random.default_rng(2).dirichlet(np.ones(8), size=5)).float()
    dense = torch.from_numpy(tnoise.confusion_matrix(n, p)).float()
    if transpose:
        dense = dense.T
    torch.testing.assert_close(tmle._confuse_probs(rows, m2, n),
                               rows @ dense.T, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tmle._confuse_probs(rows, m2, n).numpy(),
        np.asarray(jmle._confuse_probs(jnp.asarray(rows.numpy()),
                                       jnp.asarray(m2.numpy()), n)),
        atol=1e-6)


def test_auto_iters_per_call_matches_jax():
    for n, rows, iters in ((3, 27, 4000), (7, 2187, 4000), (8, 6561, 100)):
        assert tmle._auto_iters_per_call(n, rows, iters) == \
            jmle._auto_iters_per_call(n, rows, iters)
    assert tmle._FACTORED_BLOCK_ELEMS == jmle._FACTORED_BLOCK_ELEMS
