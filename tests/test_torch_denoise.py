"""Port parity for denoise mode: ``match_timestep``, ``p_denoise`` against
the exact propagation of the JAX package's tables, and the deterministic
tail of ``run_experiment(infer_mode='denoise')`` against the JAX package's
on the same JAX-written data cache (CPU)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddqst_tpu import config as jcfg
from ddqst_tpu import pipeline as jpipe
from ddqst_tpu.models import d3pm as jd3pm
from ddqst_tpu.ops import diffusion as jdiff
from ddqst_tpu.ops import schedules as jsched
from ddqst_tpu_torch import config as tcfg
from ddqst_tpu_torch import pipeline as tpipe
from ddqst_tpu_torch.models import d3pm as td3pm
from ddqst_tpu_torch.models import params_from_flax
from ddqst_tpu_torch.ops import diffusion as tdiff
from ddqst_tpu_torch.ops import schedules as tsched

# The suite runs in several xdist workers; one intra-op thread each keeps
# torch from oversubscribing the cores.
torch.set_num_threads(1)

N, T = 2, 12
G = 2**N


@pytest.mark.parametrize("kind", ["linear", "cosine", "notebook"])
def test_match_timestep_equals_jax(kind):
    js = jsched.make_schedule(kind, 100)
    ts = tsched.make_schedule(kind, 100)
    # The pipeline's rates (max(readout_p, 0.01): 0.01, 0.015) and others.
    # A rate exactly on a knot of the linear family's linspace is left out:
    # the packages' float32 knots may differ in the last bit there.
    for p in (0.0, 0.001, 0.01, 0.015, 0.05, 0.2, 0.4925, 0.9):
        assert tdiff.match_timestep(ts, p) == jdiff.match_timestep(js, p), p


def _model_pair():
    """A flax FiLM denoiser with seeded weights and the port's copy."""
    fm = jd3pm.ConditionalD3PM(num_qubits=N, num_bases=3**N, num_timesteps=T,
                               embed_dim=8, hidden_dim=32, num_blocks=2)
    z = jnp.zeros((2, N), jnp.int8)
    params = fm.init(jax.random.key(3), z, jnp.ones((2,), jnp.int32),
                     jnp.zeros((2,), jnp.int32))["params"]
    tm = td3pm.ConditionalD3PM(N, 3**N, T, embed_dim=8, hidden_dim=32,
                               num_blocks=2)
    tm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                               params)))
    return fm, params, tm.eval()


def _tv_bound(g, shots):
    return 4 * math.sqrt(g / (2 * math.pi * shots))  # 4 shot-noise scales


@pytest.mark.parametrize("exact", [True, False])
def test_p_denoise_follows_the_exact_propagation_of_jax_tables(exact):
    """From fixed one-hot starts (basis, x_{t*}), the denoised histogram is
    within 4 shot-noise scales (TV) of the exact propagation of the JAX
    package's grid tables over steps t*..1."""
    fm, params, tm = _model_pair()
    t_star = 5
    tables = np.asarray(jdiff.grid_p1_tables(
        lambda x, t, b: fm.apply({"params": params}, x, t, b), N,
        jsched.cosine_schedule(T), exact=exact), np.float64)
    tables = tables.reshape(T, 3**N, G, N)
    y = (np.arange(G)[:, None] >> np.arange(N)) & 1  # [G, N] bits of y
    starts = [(4, 0), (8, 3), (1, 2)]
    shots = 10_000
    basis = torch.tensor([b for b, _ in starts]).repeat_interleave(shots)
    x0 = torch.tensor([[(x >> q) & 1 for q in range(N)] for _, x in starts],
                      dtype=torch.int8).repeat_interleave(shots, dim=0)
    out = tdiff.p_denoise(torch.Generator().manual_seed(0), tm, x0, basis,
                          t_star, tsched.cosine_schedule(T), exact=exact)
    assert out.shape == (len(starts) * shots, N) and out.dtype == torch.int8
    idx = (out.long() * (1 << torch.arange(N))).sum(-1).reshape(len(starts),
                                                                shots)
    for row, (b, x) in enumerate(starts):
        dist = np.zeros(G)
        dist[x] = 1.0
        for t in range(t_star, 0, -1):
            p1 = tables[T - t, b][:, None, :]  # [x, 1, N]
            trans = np.prod(p1 * y + (1 - p1) * (1 - y), axis=-1)  # [x, y]
            dist = dist @ trans
        hist = np.bincount(idx[row].numpy(), minlength=G) / shots
        tv = 0.5 * np.abs(hist - dist).sum()
        assert tv < _tv_bound(G, shots), (b, x, tv)


def test_denoise_dataset_chunks_and_keeps_rows(monkeypatch):
    _, _, tm = _model_pair()
    sched = tsched.cosine_schedule(T)
    bits = torch.zeros((10, N), dtype=torch.int8)
    basis = torch.arange(10) % 9
    calls = []
    real = tdiff.p_denoise
    monkeypatch.setattr(tdiff, "p_denoise",
                        lambda g, f, x, *a: calls.append(len(x)) or real(
                            g, f, x, *a))
    monkeypatch.setattr(tdiff, "_DENOISE_CHAIN_CAP", 4)
    out = tdiff.denoise_dataset(torch.Generator().manual_seed(0), tm, bits,
                                basis, 3, sched)
    assert out.shape == (10, N) and out.dtype == torch.int8
    assert calls == [4, 4, 2]
    # t* = 1 with the renoise rule: one draw of x0_hat and no re-noising.
    out = tdiff.denoise_dataset(torch.Generator().manual_seed(0),
                                lambda x, t, b: torch.tensor([-1e9, 1e9]
                                                             ).expand(*x.shape, 2),
                                bits, basis, 1, sched, exact=False)
    assert bool((out == 1).all())


# --- the deterministic tail of denoise mode ------------------------------

SHOTS_TRAIN, SHOTS_INFER = 200, 500  # reps = 3


def _denoise_cfg(cfg_mod, reconstruction):
    c = cfg_mod.get_preset("rqc")
    return c.replace(
        model=dataclasses.replace(c.model, embed_dim=8, hidden_dim=16,
                                  num_blocks=1),
        diffusion=dataclasses.replace(c.diffusion, num_timesteps=10,
                                      infer_mode="denoise"),
        train=dataclasses.replace(c.train, num_epochs=1),
        data=dataclasses.replace(c.data, shots_train=SHOTS_TRAIN,
                                 shots_infer=SHOTS_INFER,
                                 mitigate_readout=True,
                                 reconstruction=reconstruction),
    )


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """A JAX-written cache of all 27 bases, and one without the Z...Z row."""
    tmp = tmp_path_factory.mktemp("denoise")
    cfg = _denoise_cfg(jcfg, "linear")
    data = jpipe.generate_training_data(cfg, jax.random.key(7),
                                        np.random.default_rng(7))
    full = str(tmp / "full.npz")
    jpipe.save_data_cache(full, data)
    keep = np.arange(26)  # the canonical Z...Z basis is the last one
    part = dataclasses.replace(data, bits=data.bits[keep],
                               basis_labels=data.basis_labels[keep],
                               basis_idx=data.basis_idx[keep],
                               clean_probs=data.clean_probs[keep])
    sub = str(tmp / "no_zzz.npz")
    jpipe.save_data_cache(sub, part)
    return {"full": full, "no_zzz": sub}


@pytest.mark.parametrize("cache,reconstruction", [
    ("full", "linear"), ("full", "mle"), ("no_zzz", "linear")])
def test_denoise_tail_equals_jax(caches, cache, reconstruction, monkeypatch):
    """Each package's ``denoise_dataset`` returns its input bits, so the
    samples are the tiled measured shots: the tail (tiling, reconstruction
    over the data's labels without mitigation, metrics, z_bias) must equal
    the JAX package's."""
    monkeypatch.setattr(jdiff, "denoise_dataset",
                        lambda key, apply_fn, params, bits, *a, **k: bits)
    monkeypatch.setattr(tdiff, "denoise_dataset",
                        lambda gen, fn, bits, *a, **k: bits)
    path = caches[cache]
    jres = jpipe.run_experiment(_denoise_cfg(jcfg, reconstruction), seed=0,
                                data_cache=path, log_fn=lambda m: None)
    logs = []
    tres = tpipe.run_experiment(_denoise_cfg(tcfg, reconstruction), seed=0,
                                data_cache=path, device="cpu",
                                log_fn=logs.append)
    bits = tpipe.load_data_cache(path).bits
    b, s, _ = bits.shape
    reps = -(-SHOTS_INFER // SHOTS_TRAIN)
    samples = tres["samples"]
    assert tuple(samples.shape) == (b, reps * s, 3)
    for r in range(reps):  # each basis' shots, rep by rep
        assert torch.equal(samples[:, r * s:(r + 1) * s], bits)
    np.testing.assert_array_equal(samples.numpy(), np.asarray(jres["samples"]))
    atol = 2e-4 if reconstruction == "mle" else 1e-5
    np.testing.assert_allclose(tres["rho"], jres["rho"], atol=atol)
    for k in ("fidelity", "raw_fidelity", "raw_fidelity_mitigated",
              "trace_distance", "purity"):
        assert tres[k] == pytest.approx(jres[k], abs=atol), k
    if cache == "no_zzz":
        assert tres["z_bias"] is None and jres["z_bias"] is None
    else:
        assert tres["z_bias"] == pytest.approx(jres["z_bias"], abs=1e-6)
    assert "denoise" in tres["timings"] and "walk" not in tres["timings"]
    if reconstruction == "mle":
        assert set(tres["mle_iterations"]) == {"samples", "raw"}
    t_star = tdiff.match_timestep(tsched.cosine_schedule(10), 0.015)
    assert any(f"x{reps} from t*={t_star}" in m for m in logs)


def test_distillation_in_denoise_mode_is_skipped_with_jax_warning(caches):
    c = _denoise_cfg(tcfg, "linear")
    c = c.replace(train=dataclasses.replace(c.train, chain_finetune_steps=3))
    logs = []
    res = tpipe.run_experiment(c, seed=0, data_cache=caches["full"],
                               device="cpu", log_fn=logs.append)
    assert "chain_info" not in res and "distill" not in res["timings"]
    assert any("WARNING: chain distillation skipped (needs infer_mode="
               "'generate' and the full canonical basis set)" in m
               for m in logs)
    assert 0 < res["fidelity"] <= 1.001


def test_shadow_config_in_denoise_mode_takes_the_shadow_route():
    c = tcfg.get_preset("shadow_transformer")
    c = c.replace(
        model=dataclasses.replace(c.model, embed_dim=8, hidden_dim=16,
                                  num_blocks=1, num_heads=2),
        diffusion=dataclasses.replace(c.diffusion, num_timesteps=4,
                                      infer_mode="denoise"),
        train=dataclasses.replace(c.train, num_epochs=1),
        data=dataclasses.replace(c.data, num_qubits=7, max_bases=3,
                                 shots_train=64, shots_infer=32))
    res = tpipe.run_experiment(c, seed=0, device="cpu", log_fn=lambda m: None)
    assert res["fidelity"] is None and "mean_tv_to_target" in res
    assert tuple(res["samples"].shape) == (3, 32, 7)
    assert "denoise" not in res["timings"]
