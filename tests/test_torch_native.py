"""Port parity: the C++ statevector engine (``ddqst_tpu_torch.qsim.
native_engine``, built from ``ddqst_tpu_torch/csrc/statevec.cc``) against
``ddqst_tpu.qsim.native_engine`` and against the port's numpy path (CPU).

Both engines compile the same source with the same compiler and flags
(``g++ -O3 -shared -fPIC``) from the same gate matrices, so their outputs
must be equal bit for bit. Against the numpy path the tolerance is the JAX
package's own (2e-6 on amplitudes, 1e-5 on norms, tests/test_native.py).
"""

import os
import stat
import subprocess
import sys
import time

import numpy as np
import pytest

from ddqst_tpu.qsim import native_engine as jengine
from ddqst_tpu.qsim import states as jstates
from ddqst_tpu_torch.ops import _build
from ddqst_tpu_torch.qsim import native_engine as tengine
from ddqst_tpu_torch.qsim import states as tstates

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-6
NORM_ATOL = 1e-5


@pytest.fixture(scope="module")
def jax_engine():
    """The JAX engine, loaded. It builds its library in place next to its
    source, not atomically, and other test files in other workers may be
    building it at the same moment: a load that finds a half-written file
    raises OSError, so retry a few times before giving up."""
    for attempt in range(10):
        try:
            assert jengine.available(), "the JAX package's engine did not build"
            return jengine
        except OSError:
            if attempt == 9:
                raise
            time.sleep(0.5)


def _to_jax(circuits):
    """The same circuits as the JAX package's dataclasses."""
    return [jstates.Circuit(c.num_qubits,
                            tuple(jstates.Gate(g.name, g.qubits, g.params)
                                  for g in c.gates), c.depth)
            for c in circuits]


def _check(circuits, jax_engine):
    """Port engine == JAX engine bit for bit, within ATOL of the numpy path,
    norms within NORM_ATOL; returns the port's statevectors."""
    got = tengine.statevectors(circuits)
    n = circuits[0].num_qubits
    assert got.shape == (len(circuits), 2**n) and got.dtype == np.complex64
    np.testing.assert_array_equal(got, jax_engine.statevectors(_to_jax(circuits)))
    ref = np.stack([tstates.circuit_statevector(c) for c in circuits])
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0,
                               atol=NORM_ATOL, rtol=0)
    return got


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6])
def test_random_circuits_match_jax_engine_and_numpy(n, jax_engine):
    rng = np.random.default_rng(100 + n)
    circuits = [tstates.random_circuit(rng, n, int(rng.integers(1, 11)))
                for _ in range(12)]
    _check(circuits, jax_engine)


@pytest.mark.parametrize("kind,n,want", [
    ("bell", 2, tstates.bell_state()),
    ("ghz", 3, tstates.ghz_state(3)),
    ("ghz", 6, tstates.ghz_state(6)),
])
def test_named_states(kind, n, want, jax_engine):
    got = _check([tstates.prep_circuit(kind, n)], jax_engine)
    np.testing.assert_allclose(got[0], want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name,params", [
    ("cx", ()), ("cz", ()), ("swap", ()), ("cp", (0.7,)), ("cry", (1.3,)),
])
@pytest.mark.parametrize("pair", [(0, 2), (2, 0), (1, 3), (3, 1)])
def test_two_qubit_gate_in_both_qubit_orders(name, params, pair, jax_engine):
    """A 2-qubit gate's matrix is little-endian in its own qubit list: the
    same gate on (a, b) and (b, a) gives different states, each the numpy
    path's, on a state with every amplitude set."""
    rng = np.random.default_rng(7)
    prep = tuple(tstates.Gate("u3", (q,), tuple(rng.uniform(0, 6.28, 3)))
                 for q in range(4))
    circuits = [tstates.Circuit(4, prep + (tstates.Gate(name, pair, params),))]
    _check(circuits, jax_engine)


def test_control_on_high_qubit():
    # CX with control q1, target q0 after X on q1: |10> -> |11>.
    c = tstates.Circuit(2, (tstates.Gate("x", (1,)),
                            tstates.Gate("cx", (1, 0))))
    out = tengine.statevectors([c])[0]
    np.testing.assert_array_equal(np.abs(out), [0, 0, 0, 1])


@pytest.mark.parametrize("n", [1, 4])
def test_circuit_without_gates_gives_all_zeros_state(n, jax_engine):
    rng = np.random.default_rng(3)
    # Gate-free circuits beside others in one batch: each keeps its slice.
    circuits = [tstates.Circuit(n, ()),
                tstates.random_circuit(rng, n, 3),
                tstates.Circuit(n, ())]
    got = _check(circuits, jax_engine)
    want = np.zeros(2**n, np.complex64)
    want[0] = 1
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[2], want)
    only = tengine.statevectors([tstates.Circuit(n, ())])
    np.testing.assert_array_equal(only, want[None])


@pytest.mark.parametrize("prefer_native", [True, False])
def test_empty_batch(prefer_native, jax_engine):
    got = tstates.batch_statevectors([], prefer_native=prefer_native)
    assert got.shape == (0, 0) and got.dtype == np.complex64
    want = jstates.batch_statevectors([])  # the JAX package's default path
    assert want.shape == got.shape and want.dtype == got.dtype


@pytest.mark.parametrize("n", [2, 3, 5])
def test_batch_statevectors_paths_agree(n, jax_engine):
    rng = np.random.default_rng(n)
    circuits = [tstates.random_circuit(rng, n, int(rng.integers(2, 11)))
                for _ in range(20)]
    native = tstates.batch_statevectors(circuits)
    np.testing.assert_array_equal(
        native, tstates.batch_statevectors(circuits, prefer_native=True))
    np.testing.assert_array_equal(native, tengine.statevectors(circuits))
    numpy_path = tstates.batch_statevectors(circuits, prefer_native=False)
    np.testing.assert_array_equal(
        numpy_path, np.stack([tstates.circuit_statevector(c) for c in circuits]))
    np.testing.assert_allclose(native, numpy_path, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(
        native, jstates.batch_statevectors(_to_jax(circuits)))


@pytest.mark.parametrize("bad", [
    [tstates.Circuit(2, ()), tstates.Circuit(3, ())],
    [tstates.Circuit(2, (tstates.Gate("x", (2,)),))],
    [tstates.Circuit(2, (tstates.Gate("x", (-1,)),))],
    [tstates.Circuit(3, (tstates.Gate("cx", (1, 1)),))],
    [tstates.Circuit(3, (tstates.Gate("cx", (0, 3)),))],
])
def test_out_of_range_input_raises(bad):
    with pytest.raises(ValueError):
        tengine.statevectors(bad)


def _failing_compiler(tmp_path):
    path = tmp_path / "cxx"
    path.write_text("#!/bin/sh\necho 'statevec.cc:1: error: no compiler "
                    "here' >&2\nexit 3\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path), "no compiler here"


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_failed_build_raises_and_returns_no_numpy_result(
        compiler, tmp_path, monkeypatch):
    if compiler == "missing":
        cxx, said = str(tmp_path / "no" / "such" / "g++"), "not found"
    else:
        cxx, said = _failing_compiler(tmp_path)
    build_dir = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(_build, "CXX", cxx)
    monkeypatch.setattr(_build, "_loaded", {})
    circuits = [tstates.prep_circuit("bell", 2)]
    for call in (lambda: tengine.statevectors(circuits),
                 lambda: tstates.batch_statevectors(circuits),
                 lambda: tstates.batch_statevectors([])):
        with pytest.raises(RuntimeError, match=said):
            call()
    assert not tengine.available()
    built = os.listdir(build_dir) if build_dir.exists() else []
    assert not [f for f in built if f.endswith(".so")]
    # The numpy path does not need the engine.
    np.testing.assert_allclose(
        tstates.batch_statevectors(circuits, prefer_native=False)[0],
        tstates.bell_state(), atol=ATOL, rtol=0)


def _listing(directory):
    return sorted((f, os.stat(os.path.join(directory, f)).st_mtime_ns)
                  for f in os.listdir(directory))


def test_library_lands_in_build_dir_under_hashed_name():
    before = _listing(_build.CSRC)
    tengine.statevectors([tstates.prep_circuit("ghz", 3)])
    path = _build.library_path("statevec")
    assert os.path.dirname(path) == _build.BUILD_DIR
    name = os.path.basename(path)
    assert name.startswith("libstatevec_") and name.endswith(".so")
    assert len(name) == len("libstatevec_.so") + 12
    assert os.path.exists(path)
    assert _build.load("statevec")._name == path
    assert _listing(_build.CSRC) == before


def test_library_name_hashes_source_and_host_flags(tmp_path, monkeypatch):
    path = _build.library_path("statevec")
    monkeypatch.setattr(_build, "HOST_FLAGS", ("-O2", "-shared", "-fPIC"))
    assert _build.library_path("statevec") != path
    monkeypatch.undo()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    with open(os.path.join(_build.CSRC, "statevec.cc")) as f:
        (csrc / "statevec.cc").write_text(f.read() + "\n// edited\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    assert _build.library_path("statevec") != path


def test_concurrent_builds_share_one_library(tmp_path):
    """Processes building at once into one directory (as test workers do)
    all load a whole library and leave no temporary file."""
    code = (
        "import sys\n"
        "from ddqst_tpu_torch.ops import _build\n"
        "_build.BUILD_DIR = sys.argv[1]\n"
        "from ddqst_tpu_torch.qsim import native_engine, states\n"
        "psi = native_engine.statevectors([states.prep_circuit('ghz', 4)])\n"
        "assert abs(abs(psi[0, 0]) ** 2 - 0.5) < 1e-6, psi\n"
        "print(_build.library_path('statevec'))\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert len({out.strip() for out, _ in outs}) == 1
    left = os.listdir(tmp_path)
    assert [f for f in left if f.endswith(".so")] == [
        os.path.basename(outs[0][0].strip())]
    assert not [f for f in left if f.endswith(".tmp")]
