"""Port parity: dataset records, builders and loaders against ddqst_tpu
(CPU). Circuits, hashes, depths, basis plans and clean states are drawn
from the same numpy seed and must be equal; the counts come from another
generator and must match the same probabilities in distribution."""

import os

import numpy as np
import pytest
import torch

from ddqst_tpu.data import generate as jgen
from ddqst_tpu.data import loader as jloader
from ddqst_tpu.data import records as jrec
from ddqst_tpu.ops.complexlib import from_complex
from ddqst_tpu.qsim import measure as jmeasure
from ddqst_tpu.qsim import noise as jnoise
from ddqst_tpu.qsim import states as jstates
from ddqst_tpu_torch.data import generate as tgen
from ddqst_tpu_torch.data import loader as tloader
from ddqst_tpu_torch.data import records as trec
from ddqst_tpu_torch.qsim import measure as tmeasure
from ddqst_tpu_torch.qsim import noise as tnoise
from ddqst_tpu_torch.qsim import states as tstates

# The suite runs in several xdist workers; one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)

FIELDS = ("id", "hash", "depth", "clean_state", "basis_labels", "counts")


def _mk_record(cls, i, n=2, bases=9):
    rng = np.random.default_rng(i)
    d = 2**n
    psi = rng.normal(size=d) + 1j * rng.normal(size=d)
    psi /= np.linalg.norm(psi)
    return cls(
        id=i, hash=f"hash{i}", depth=3 + i,
        clean_state=psi.astype(np.complex64),
        basis_labels=rng.integers(0, 3, (bases, n)).astype(np.int8),
        counts=rng.integers(0, 50, (bases, d)).astype(np.int32),
    )


def _assert_records_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for f in FIELDS:
            va, vb = getattr(ra, f), getattr(rb, f)
            if isinstance(va, np.ndarray):
                assert va.dtype == vb.dtype, f
                np.testing.assert_array_equal(va, vb, err_msg=f)
            else:
                assert va == vb, f


@pytest.mark.parametrize("writer,reader", [(jrec, trec), (trec, jrec)])
def test_shards_round_trip_between_packages(tmp_path, writer, reader):
    recs = [_mk_record(writer.CircuitRecord, i) for i in range(3)]
    path = str(tmp_path / "part_0.npz")
    writer.save_shard(path, recs)
    _assert_records_equal(reader.load_shard(path), recs)
    _assert_records_equal(reader.load_dataset(str(tmp_path)), recs)


def test_load_dataset_skips_corrupt(tmp_path):
    trec.save_shard(str(tmp_path / "part_0.npz"), [_mk_record(trec.CircuitRecord, 0)])
    (tmp_path / "part_1.npz").write_bytes(b"not a zip")
    assert len(trec.load_dataset(str(tmp_path))) == 1


def test_convert_reference_pt_matches_jax(tmp_path):
    """A synthetic reference part (a torch-pickled list of dicts) converts
    to the same shard in both packages."""
    rng = np.random.default_rng(5)
    entries = []
    for i in range(3):
        psi = rng.normal(size=8) + 1j * rng.normal(size=8)
        meas = []
        for basis in ("XYZ", "ZZZ", "YXZ"):
            keys = rng.choice(8, 4, replace=False)
            meas.append({"basis": basis,
                         "counts": {format(int(k), "03b"): int(rng.integers(1, 300))
                                    for k in keys}})
        entries.append({"clean_state_vec": (psi / np.linalg.norm(psi)),
                        "measurements": meas, "id": 10 + i, "hash": f"h{i}",
                        "depth": 2 + i})
    src = str(tmp_path / "part_7.pt")
    torch.save(entries, src)
    out_j = jrec.convert_reference_pt(src, str(tmp_path / "j"))
    out_t = trec.convert_reference_pt(src, str(tmp_path / "t"))
    assert [os.path.basename(p) for p in out_t] == ["part_7.npz"]
    recs = trec.load_shard(out_t[0])
    _assert_records_equal(recs, jrec.load_shard(out_j[0]))
    assert recs[1].id == 11 and recs[2].depth == 4
    assert recs[0].counts.sum() == sum(
        sum(m["counts"].values()) for m in entries[0]["measurements"])
    np.testing.assert_array_equal(recs[0].basis_labels[0], [0, 1, 2])


def _build_pair(seed, n, max_bases, noise="torino", num=3, shots=64):
    kw = dict(seed=seed, num_samples=num, num_qubits=n, min_depth=2,
              max_depth=5, shots=shots, noise_type=noise, max_bases=max_bases)
    return jgen.build_dataset(**kw), tgen.build_dataset(**kw, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n,max_bases", [(2, 0), (3, 0), (5, 0)])
def test_build_dataset_matches_jax(seed, n, max_bases):
    """Ids, hashes, depths, basis plans and clean states equal JAX's; at
    N=5, max_bases=0 caps at 100 random bases per circuit."""
    jr, tr = _build_pair(seed, n, max_bases)
    assert len(jr) == len(tr) == 3
    for a, b in zip(jr, tr):
        assert (a.id, a.hash, a.depth) == (b.id, b.hash, b.depth)
        np.testing.assert_array_equal(a.basis_labels, b.basis_labels)
        assert b.basis_labels.shape == ((100, 5) if n == 5 else (3**n, n))
        # Both packages take their C++ statevector engines.
        np.testing.assert_allclose(a.clean_state, b.clean_state, atol=1e-6)
        assert b.counts.shape == a.counts.shape and b.counts.dtype == np.int32
        assert (b.counts.sum(axis=1) == 64).all()


def test_circuit_hash_matches_jax():
    rng_j, rng_t = np.random.default_rng(9), np.random.default_rng(9)
    for depth in (1, 4, 9):
        qj = jstates.random_circuit(rng_j, 3, depth)
        qt = tstates.random_circuit(rng_t, 3, depth)
        assert jstates.circuit_hash(qj) == tstates.circuit_hash(qt)


def _chunk_inputs(noise_type, n=3, c=4, b=7):
    rng = np.random.default_rng(11)
    circuits = [tstates.random_circuit(rng, n, 5) for _ in range(c)]
    jcirc = [jstates.Circuit(q.num_qubits, tuple(
        jstates.Gate(g.name, g.qubits, g.params) for g in q.gates), q.depth)
        for q in circuits]
    labels = rng.integers(0, 3, (c, b, n)).astype(np.int32)
    rots = jmeasure.rotation_unitaries(labels.reshape(c * b, n)).reshape(
        c, b, 2**n, 2**n)
    return circuits, jcirc, labels, rots, jnoise.get_noise_config(noise_type)


@pytest.mark.parametrize("noise_type", ["torino", "readout"])
def test_per_circuit_probs_match_jax(noise_type):
    """The probabilities the counts are drawn from: the mixed path under
    gate noise (torino), the pure path otherwise, then readout."""
    circuits, jcirc, labels, rots, ncfg = _chunk_inputs(noise_type)
    n = 3
    if ncfg.has_gate_noise:
        rhos = np.stack([jnoise.simulate_density_matrix(q, ncfg) for q in jcirc])
        ref = jmeasure.batched_probs_mixed_per_circuit(from_complex(rhos),
                                                       from_complex(rots))
        trhos = np.stack([tnoise.simulate_density_matrix(q, ncfg)
                          for q in circuits])
        out = tmeasure.batched_probs_mixed_per_circuit(
            torch.from_numpy(trhos), torch.from_numpy(rots))
    else:
        psis = jstates.batch_statevectors(jcirc)
        ref = jmeasure.batched_probs_pure_per_circuit(from_complex(psis),
                                                      from_complex(rots))
        out = tmeasure.batched_probs_pure_per_circuit(
            torch.from_numpy(tstates.batch_statevectors(circuits)),
            torch.from_numpy(rots))
    ref = jnoise.apply_readout_to_probs(ref, n, ncfg.readout_p)
    out = tnoise.apply_readout_to_probs(out, n, ncfg.readout_p)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_simulated_counts_follow_their_probs():
    circuits, _, labels, rots, ncfg = _chunk_inputs("torino", b=5)
    shots = 20_000
    counts = tgen._simulate_chunk(torch.Generator().manual_seed(0), circuits,
                                  labels, shots, ncfg)
    assert counts.shape == (4, 5, 8) and counts.dtype == np.int32
    assert (counts.sum(axis=-1) == shots).all()
    rhos = np.stack([tnoise.simulate_density_matrix(q, ncfg) for q in circuits])
    probs = tnoise.apply_readout_to_probs(
        tmeasure.batched_probs_mixed_per_circuit(torch.from_numpy(rhos),
                                                 torch.from_numpy(rots)),
        3, ncfg.readout_p).numpy()
    tv = 0.5 * np.abs(counts / shots - probs).sum(-1)
    assert (tv < 4 * np.sqrt(8 / (2 * np.pi * shots))).all(), tv.max()


def test_build_dataset_chunked_resume(tmp_path):
    out = str(tmp_path / "ds")
    kw = dict(num_qubits=2, out_dir=out, chunk_size=2, shots=50,
              noise_type="readout", max_bases=9, log_fn=lambda *a: None,
              device="cpu")
    assert len(tgen.build_dataset_chunked(seed=0, num_samples=4, **kw)) == 2
    # Resume: ask for 6 in all -> one more chunk, earlier shards kept.
    paths = tgen.build_dataset_chunked(seed=1, num_samples=6, **kw)
    assert [os.path.basename(p) for p in paths] == [
        "part_0.npz", "part_1.npz", "part_2.npz"]
    recs = trec.load_dataset(out)
    assert len(recs) == 6 and [r.id for r in recs] == list(range(6))
    assert len({r.hash for r in recs}) == 6  # dedup survived the resume
    with open(os.path.join(out, "seen_hashes.txt")) as f:
        assert sorted(f.read().split()) == sorted(r.hash for r in recs)
    # Already complete: nothing more is built.
    assert len(tgen.build_dataset_chunked(seed=2, num_samples=6, **kw)) == 3


def test_build_dataset_chunked_matches_jax_records(tmp_path):
    kw = dict(seed=3, num_samples=5, num_qubits=2, chunk_size=2, shots=40,
              noise_type="readout", max_bases=4, log_fn=lambda *a: None)
    jgen.build_dataset_chunked(out_dir=str(tmp_path / "j"), **kw)
    tgen.build_dataset_chunked(out_dir=str(tmp_path / "t"), device="cpu", **kw)
    jr = jrec.load_dataset(str(tmp_path / "j"))
    tr = trec.load_dataset(str(tmp_path / "t"))
    assert [(r.id, r.hash, r.depth) for r in jr] == [
        (r.id, r.hash, r.depth) for r in tr]
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(a.basis_labels, b.basis_labels)


def _loader_records(cls):
    recs = [_mk_record(cls, i, n=3, bases=5) for i in range(3)]
    recs[1].counts[2] = 0  # a row with no shots is skipped
    return recs


@pytest.mark.parametrize("mode,kw", [("unroll", {}),
                                     ("sampled", dict(num_samples=3000, seed=4))])
def test_training_arrays_match_jax(mode, kw):
    ref = jloader.dataset_to_training_arrays(
        _loader_records(jrec.CircuitRecord), mode=mode, **kw)
    out = tloader.dataset_to_training_arrays(
        _loader_records(trec.CircuitRecord), mode=mode, **kw)
    for k in ("bits", "basis_idx", "basis_labels", "circuit_idx"):
        assert out[k].numpy().dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), k)


def test_shuffle_arrays_permutes_rows_together():
    arrays = tloader.dataset_to_training_arrays(
        _loader_records(trec.CircuitRecord))
    sh = tloader.shuffle_arrays(torch.Generator().manual_seed(0), arrays)
    assert not torch.equal(sh["bits"], arrays["bits"])
    key = lambda a: sorted(zip(a["basis_idx"].tolist(), a["circuit_idx"].tolist(),
                               map(tuple, a["bits"].tolist())))
    assert key(sh) == key(arrays)


def test_builders_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tgen.build_dataset(seed=0, num_samples=2, num_qubits=2)
    with pytest.raises(RuntimeError):
        tgen.build_dataset_chunked(seed=0, num_samples=2, num_qubits=2,
                                   out_dir=str(tmp_path))
