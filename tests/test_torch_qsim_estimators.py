"""Port parity: simulator, linear inversion, histograms and metrics against
ddqst_tpu on the same inputs."""

import math

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
from ddqst_tpu_torch import pipeline as tpipe
from ddqst_tpu_torch.ops import metrics as tM
from ddqst_tpu_torch.ops import mle as tmle
from ddqst_tpu_torch.ops import pauli as tpauli
from ddqst_tpu_torch.qsim import measure as tmeasure
from ddqst_tpu_torch.qsim import noise as tnoise
from ddqst_tpu_torch.qsim import states as tstates

# The suite runs in several xdist workers; one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("state_type", ["rqc", "ghz", "w"])
def test_circuit_and_target_match_jax(seed, state_type):
    jc = jstates.prep_circuit(state_type, 3, 5, np.random.default_rng(seed))
    tc = tstates.prep_circuit(state_type, 3, 5, np.random.default_rng(seed))
    assert [(g.name, g.qubits, g.params) for g in tc.gates] == [
        (g.name, g.qubits, g.params) for g in jc.gates
    ]
    np.testing.assert_array_equal(tstates.circuit_statevector(tc),
                                  jstates.circuit_statevector(jc))


@pytest.mark.parametrize("noise_type", ["torino", "readout", "ideal",
                                        "depolarizing", "thermal"])
def test_noisy_basis_probs_match_jax(noise_type):
    """Per-basis probabilities before sampling, readout included."""
    n = 3
    circ = jstates.prep_circuit("rqc", n, 5, np.random.default_rng(0))
    ncfg = jnoise.get_noise_config(noise_type)
    kind, state = jnoise.noisy_state(circ, ncfg)
    labels = jpauli.all_basis_labels(n)
    rots = from_complex(jmeasure.rotation_unitaries(labels))
    fn = (jmeasure.batched_probs_pure if kind == "pure"
          else jmeasure.batched_probs_mixed)
    ref = jnoise.apply_readout_to_probs(fn(from_complex(state[None]), rots)[0],
                                        n, ncfg.readout_p)
    tcirc = tstates.prep_circuit("rqc", n, 5, np.random.default_rng(0))
    out = tpipe.noisy_basis_probs(
        tcirc, tnoise.get_noise_config(noise_type),
        torch.from_numpy(tmeasure.rotation_unitaries(labels)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_sample_bits_follows_probs():
    probs = torch.tensor([[0.7, 0.0, 0.3, 0.0], [0.0, 0.25, 0.25, 0.5]])
    bits = tmeasure.sample_bits(torch.Generator().manual_seed(0), probs,
                                20000, 2)
    assert bits.shape == (2, 20000, 2) and bits.dtype == torch.int8
    counts = tmle.bits_to_counts(bits) / 20000
    np.testing.assert_allclose(counts.numpy(), probs.numpy(), atol=0.015)


def _random_counts(rng, n, shots=500):
    p = rng.dirichlet(np.ones(2**n), size=3**n)
    return np.stack([rng.multinomial(shots, q) for q in p]).astype(np.float32)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("readout_p,psd", [(0.0, True), (0.015, True),
                                           (0.0, False)])
def test_counts_inverter_matches_jax(n, readout_p, psd):
    counts = _random_counts(np.random.default_rng(n), n)
    ref = to_complex(jpauli.make_counts_inverter(n, psd=psd,
                                                 readout_p=readout_p)(
        jnp.asarray(counts)))
    out = tpauli.make_counts_inverter(n, psd=psd, readout_p=readout_p)(
        torch.from_numpy(counts))
    assert out.dtype == torch.complex64 and out.shape == (2**n, 2**n)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_counts_parity_means_matches_jax():
    counts = _random_counts(np.random.default_rng(7), 4)
    np.testing.assert_allclose(
        tpauli.counts_parity_means(torch.from_numpy(counts), 4).numpy(),
        np.asarray(jpauli.counts_parity_means(jnp.asarray(counts), 4)),
        atol=1e-6)


def test_non_canonical_basis_labels_raise():
    """A basis subset and "first" mode take the dense compatibility weights
    (they raised while only the factored inverter was ported); what still
    raises is an unknown mode."""
    labels = tpauli.all_basis_labels(2)[:5]
    counts = torch.from_numpy(_random_counts(np.random.default_rng(0), 2))
    for rho in (tpauli.make_counts_inverter(2, labels)(counts[:5]),
                tpauli.make_counts_inverter(2, compat_mode="first")(counts)):
        assert rho.shape == (4, 4) and abs(complex(rho.trace()) - 1) < 1e-5
    with pytest.raises(ValueError):
        tpauli.make_counts_inverter(2, labels, compat_mode="median")


_SUBSETS = {2: [0, 2, 4, 5, 8], 3: [26, 0, 13, 4, 9, 21, 22, 17, 1, 14, 8]}


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("mode", ["mean", "first"])
@pytest.mark.parametrize("readout_p,psd", [(0.0, True), (0.02, True),
                                           (0.02, False)])
def test_dense_inverter_on_a_basis_subset_matches_jax(n, mode, readout_p, psd):
    """The dense [4^N, B] path, rows in the caller's order: within 1e-5 per
    entry of ρ."""
    labels = tpauli.all_basis_labels(n)[_SUBSETS[n]]
    counts = _random_counts(np.random.default_rng(n), n)[_SUBSETS[n]]
    kw = dict(compat_mode=mode, psd=psd, readout_p=readout_p)
    ref = to_complex(jpauli.make_counts_inverter(n, labels, **kw)(
        jnp.asarray(counts)))
    out = tpauli.make_counts_inverter(n, labels, **kw)(
        torch.from_numpy(counts))
    assert out.dtype == torch.complex64
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    if not psd:  # the all-identity coefficient is exactly 1
        assert complex(out.trace()) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("n", [2, 3])
def test_first_mode_on_the_full_grid_matches_jax(n):
    counts = _random_counts(np.random.default_rng(5), n)
    ref = to_complex(jpauli.make_counts_inverter(n, compat_mode="first")(
        jnp.asarray(counts)))
    out = tpauli.make_counts_inverter(n, compat_mode="first")(
        torch.from_numpy(counts))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    # On the full grid, "mean" over the dense weights is the factored path.
    w, mask = tpauli._compat_weights(n, tpauli.all_basis_labels(n), "mean")
    par = tpauli.counts_parity_means(torch.from_numpy(counts), n)
    coeff = torch.einsum("pb,bp->p", torch.from_numpy(w),
                         par[:, torch.from_numpy(mask).long()])
    coeff[0] = 1.0
    dense = tpauli.project_psd(tpauli.coeffs_to_rho(coeff, n))
    fact = tpauli.make_counts_inverter(n)(torch.from_numpy(counts))
    np.testing.assert_allclose(dense.numpy(), fact.numpy(), atol=1e-5)


@pytest.mark.parametrize("mode", ["mean", "first"])
def test_compat_weights_match_jax(mode):
    labels = tpauli.all_basis_labels(3)[_SUBSETS[3]]
    w, mask = tpauli._compat_weights(3, labels, mode)
    jw, jmask = jpauli._compat_weights(3, labels, mode)
    assert w.shape == (64, 11) and w.dtype == np.float32
    np.testing.assert_allclose(w, jw, atol=1e-7)  # JAX keeps float64
    np.testing.assert_array_equal(mask, jmask)
    sums = w.sum(1)
    assert set(np.round(sums, 5)) <= {0.0, 1.0} and round(sums[0], 5) == 1.0


def _random_bits(rng, b, s, n):
    return rng.integers(0, 2, (b, s, n)).astype(np.int8)


@pytest.mark.parametrize("weighted", [False, True])
def test_subset_parity_means_match_jax(weighted):
    rng = np.random.default_rng(3)
    bits = _random_bits(rng, 5, 200, 3)
    w = (rng.integers(0, 3, (5, 200)).astype(np.float32) if weighted
         else None)
    out = tpauli.subset_parity_means(
        torch.from_numpy(bits), None if w is None else torch.from_numpy(w))
    ref = jpauli.subset_parity_means(
        jnp.asarray(bits), None if w is None else jnp.asarray(w))
    assert out.shape == (5, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    if not weighted:  # the same parities as the histogram route
        np.testing.assert_allclose(
            out.numpy(),
            tpauli.counts_parity_means(
                tmle.bits_to_counts(torch.from_numpy(bits)), 3).numpy(),
            atol=1e-6)


@pytest.mark.parametrize("subset,weighted", [(False, False), (True, False),
                                             (True, True)])
def test_make_inverter_from_bits_matches_jax(subset, weighted):
    n = 2
    rng = np.random.default_rng(9)
    rows = _SUBSETS[n] if subset else list(range(9))
    labels = tpauli.all_basis_labels(n)[rows]
    bits = _random_bits(rng, len(rows), 300, n)
    w = rng.random((len(rows), 300)).astype(np.float32) if weighted else None
    ref = to_complex(jpauli.make_inverter(n, labels, readout_p=0.01)(
        jnp.asarray(bits), None if w is None else jnp.asarray(w)))
    out = tpauli.make_inverter(n, labels, readout_p=0.01)(
        torch.from_numpy(bits), None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_linear_inversion_matches_jax():
    bits = _random_bits(np.random.default_rng(2), 9, 250, 2)
    for mode in ("mean", "first"):
        ref = to_complex(jpauli.linear_inversion(jnp.asarray(bits), 2,
                                                 compat_mode=mode))
        out = tpauli.linear_inversion(torch.from_numpy(bits), 2,
                                      compat_mode=mode)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_label_helpers_match_jax():
    np.testing.assert_array_equal(tpauli.all_pauli_labels(3),
                                  jpauli.all_pauli_labels(3))
    assert tpauli.all_pauli_labels(2).shape == (16, 2)
    for row in tpauli.all_basis_labels(3)[[0, 5, 26]]:
        s = tpauli.basis_label_to_str(row)
        assert s == jpauli.basis_label_to_str(row)
        np.testing.assert_array_equal(tpauli.basis_str_to_label(s), row)
    assert tpauli.basis_label_to_str(np.array([0, 1, 2])) == "XYZ"


def _rho_pair(rng, n=3):
    """A random full-rank state and a near-pure state (complex64)."""
    d = 2**n
    a = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    rho = a @ a.conj().T
    rho /= np.trace(rho)
    psi = jstates.circuit_statevector(
        jstates.prep_circuit("rqc", n, 5, np.random.default_rng(3)))
    sigma = 0.9 * np.outer(psi, psi.conj()) + 0.1 * rho
    return rho.astype(np.complex64), sigma.astype(np.complex64), psi


def test_metrics_match_jax():
    rho, sigma, psi = _rho_pair(np.random.default_rng(0))
    t = torch.from_numpy
    pairs = [
        (tM.state_fidelity(t(psi), t(rho)), jM.state_fidelity(psi, rho)),
        (tM.state_fidelity(t(rho), t(psi)), jM.state_fidelity(rho, psi)),
        (tM.state_fidelity(t(psi), t(psi)), jM.state_fidelity(psi, psi)),
        (tM.state_fidelity(t(rho), t(sigma)), jM.state_fidelity(rho, sigma)),
        (tM.trace_distance(t(psi), t(rho)), jM.trace_distance(psi, rho)),
        (tM.trace_distance(t(rho), t(sigma)), jM.trace_distance(rho, sigma)),
        (tM.purity(t(rho)), jM.purity(rho)),
        (tM.von_neumann_entropy(t(rho)), jM.von_neumann_entropy(rho)),
        (tM.von_neumann_entropy(t(sigma)), jM.von_neumann_entropy(sigma)),
        (tM.entanglement_entropy(t(sigma), 3), jM.entanglement_entropy(sigma, 3)),
    ]
    for out, ref in pairs:
        np.testing.assert_allclose(float(out), float(ref), atol=1e-4)
    for x in (rho, sigma):
        got, want = tM.pauli_expectations(t(x)), jM.pauli_expectations(x)
        assert got.keys() == want.keys()
        np.testing.assert_allclose(list(got.values()), list(want.values()),
                                   atol=1e-5)
    z = np.random.default_rng(1).integers(0, 2, (500, 3)).astype(np.int8)
    assert float(tM.z_bias(t(z))) == pytest.approx(float(jM.z_bias(jnp.asarray(z))))


def test_fidelity_clamp_rule():
    assert float(tM._clamp_fid(torch.tensor(1.0005))) == 1.0
    assert float(tM._clamp_fid(torch.tensor(1.01))) == pytest.approx(1.01)
    assert float(tM._clamp_fid(torch.tensor(0.97))) == pytest.approx(0.97)


def test_bits_to_counts_matches_jax_exactly():
    bits = np.random.default_rng(4).integers(0, 2, (9, 333, 3)).astype(np.int8)
    out = tmle.bits_to_counts(torch.from_numpy(bits))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jmle.bits_to_counts(jnp.asarray(bits))))


@pytest.mark.parametrize("seed", [0, 1])
def test_circuit_unitary_matches_jax(seed):
    c = jstates.prep_circuit("rqc", 3, 4, np.random.default_rng(seed))
    ref = jstates.circuit_unitary(c)
    got = tstates.circuit_unitary(tstates.prep_circuit(
        "rqc", 3, 4, np.random.default_rng(seed)))
    assert got.dtype == np.complex64 and got.shape == (8, 8)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(got[:, 0], tstates.circuit_statevector(
        tstates.prep_circuit("rqc", 3, 4, np.random.default_rng(seed))),
        atol=1e-6)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_named_states_match_jax(n):
    for name in ("plus_state", "ghz_state", "w_state"):
        got = getattr(tstates, name)(n)
        assert got.dtype == np.complex64
        np.testing.assert_allclose(got, getattr(jstates, name)(n), atol=1e-6)
    np.testing.assert_allclose(tstates.bell_state(), jstates.bell_state(),
                               atol=1e-6)
    # The named vectors are the prepared circuits' states.
    for name, kind in (("ghz_state", "ghz"), ("w_state", "w")):
        psi = tstates.circuit_statevector(tstates.prep_circuit(kind, n))
        np.testing.assert_allclose(psi, getattr(tstates, name)(n), atol=1e-6)


@pytest.mark.parametrize("label", [(0,), (1, 2), (2, 0, 1), (1, 1, 0, 2)])
def test_rotation_unitary_and_measurement_probs_match_jax(label):
    n = len(label)
    np.testing.assert_allclose(tmeasure.rotation_unitary(label),
                               jmeasure.rotation_unitary(label), atol=1e-6)
    psi = tstates.circuit_statevector(tstates.prep_circuit(
        "rqc", n, 3, np.random.default_rng(n)))
    ref = np.asarray(jmeasure.measurement_probs(psi, label))
    got = tmeasure.measurement_probs(psi, label)
    assert got.dtype == torch.float32 and got.shape == (2**n,)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(
        tmeasure.measurement_probs(torch.from_numpy(psi), label).numpy(), ref,
        atol=1e-6)


@pytest.mark.parametrize("p", [0.0, 0.015, 0.3])
def test_flip_bits_flip_rate_meets_a_binomial_bound(p):
    bits = torch.from_numpy(
        np.random.default_rng(0).integers(0, 2, (4000, 5)).astype(np.int8))
    out = tnoise.flip_bits(torch.Generator().manual_seed(1), bits, p)
    assert out.dtype == torch.int8 and out.shape == bits.shape
    m = bits.numel()
    flips = int((out != bits).sum())
    # Binomial(m, p): within 5 standard deviations.
    assert abs(flips - m * p) <= 5 * math.sqrt(m * p * (1 - p)) + 1e-9
    assert set(out.unique().tolist()) <= {0, 1}
