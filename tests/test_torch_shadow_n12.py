"""Port parity at N = 12: the shadow route of the ``shadow_transformer``
preset with only its qubit count raised to 12 (the route whose walk the
gather body of ``csrc/chain_walk.cu`` takes on the card), against
ddqst_tpu on the same weights and data (CPU; the walk's plain version
stands in for the kernel).

Cut to a CPU test: a 1-block transformer of width 16, T = 4, 2 sampled
bases, 1 training epoch in JAX; 5,000 generated shots a basis, as the
preset has, so the route walks tables (shots >= 2^12).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddqst_tpu import config as jcfg
from ddqst_tpu import pipeline as jpipe
from ddqst_tpu.models import transformer as jt
from ddqst_tpu.ops import diffusion as jdiff
from ddqst_tpu.ops import schedules as jsched
from ddqst_tpu_torch import config as tcfg
from ddqst_tpu_torch import pipeline as tpipe
from ddqst_tpu_torch.models import params_from_flax
from ddqst_tpu_torch.ops import cuda_kernels as ck
from ddqst_tpu_torch.ops import diffusion as tdiff
from ddqst_tpu_torch.ops import schedules as tsched

torch.set_num_threads(1)

N, T, BASES, SHOTS = 12, 4, 2, 5000
G = 2**N
TABLE_ATOL = 1e-5  # the assembled tables against JAX's


def _cfg(cfg_mod):
    c = cfg_mod.get_preset("shadow_transformer")
    return c.replace(
        model=dataclasses.replace(c.model, embed_dim=16, hidden_dim=32,
                                  num_blocks=1, num_heads=2),
        diffusion=dataclasses.replace(c.diffusion, num_timesteps=T),
        train=dataclasses.replace(c.train, num_epochs=1),
        data=dataclasses.replace(c.data, num_qubits=N, max_bases=BASES),
    )


def _flax_apply():
    return jt.TransformerDenoiser(num_qubits=N, num_timesteps=T, embed_dim=16,
                                  hidden_dim=32, num_blocks=1,
                                  num_heads=2).apply


@pytest.fixture(scope="module")
def route(tmp_path_factory):
    """JAX's run_experiment writes the data cache and trains the weights;
    the port runs from both (params_load, no training), keeping the tables
    it assembles and counting the walk calls."""
    tmp = tmp_path_factory.mktemp("shadow_n12")
    cache = str(tmp / "data.npz")
    jc = _cfg(jcfg)
    assert jc.data.shots_infer == SHOTS
    jres = jpipe.run_experiment(jc, seed=0, data_cache=cache,
                                log_fn=lambda m: None)
    params = jres["state"].params
    ppath = str(tmp / "params.pt")
    torch.save(params_from_flax(jax.tree_util.tree_map(np.asarray, params)),
               ppath)
    kept, walks = [], []
    assembled, walk = tdiff._assembled_tables, ck.fused_chain_walk

    def keep(*args, **kwargs):
        kept.append(assembled(*args, **kwargs))
        return kept[-1]

    def count(seed, tables, init, num_qubits, **kw):
        walks.append(tuple(init.shape))
        return walk(seed, tables, init, num_qubits, **kw)

    tdiff._assembled_tables, ck.fused_chain_walk = keep, count
    try:
        tres = tpipe.run_experiment(_cfg(tcfg), seed=0, data_cache=cache,
                                    params_load=ppath, device="cpu",
                                    log_fn=lambda m: None)
    finally:
        tdiff._assembled_tables, ck.fused_chain_walk = assembled, walk
    return dict(cache=cache, params=params, ppath=ppath, jres=jres,
                tres=tres, jc=jc, kept=kept, walks=walks)


def test_n12_route_walks_the_tables_once(route):
    """5,000 shots >= 2^12: the tables over the [2·2^12, 12] label grid,
    then one walk of 2 x 5,000 chains."""
    tres = route["tres"]
    assert [tuple(t.shape) for t in route["kept"]] == [(T, BASES, G, N)]
    assert route["walks"] == [(BASES, SHOTS)]
    assert tuple(tres["samples"].shape) == (BASES, SHOTS, N)
    assert {"datagen", "tables", "walk", "metrics"} <= set(tres["timings"])
    assert tres["train_steps"] == 0


def test_n12_port_data_equals_jax_cache(route):
    jdata = jpipe.load_data_cache(route["cache"])
    tdata = tpipe.generate_training_data(
        _cfg(tcfg), torch.Generator().manual_seed(0),
        np.random.default_rng(0))
    np.testing.assert_array_equal(tdata.basis_labels, jdata.basis_labels)
    np.testing.assert_array_equal(tdata.basis_idx, jdata.basis_idx)
    np.testing.assert_allclose(tdata.clean_probs, jdata.clean_probs,
                               atol=1e-6)
    assert np.asarray(tdata.clean_probs).shape == (BASES, G)


def test_n12_tables_equal_jax(route):
    """The tables the port's walk read equal JAX's ``_tables_for_ts`` over
    the same label grid and weights."""
    labels = np.asarray(jpipe.load_data_cache(route["cache"]).basis_labels)
    x_enum = ((np.arange(G)[:, None] >> np.arange(N)) & 1).astype(np.int8)
    grid = (jnp.asarray(np.tile(x_enum, (BASES, 1))),
            jnp.asarray(np.repeat(labels, G, axis=0).astype(np.int32)))
    apply = _flax_apply()
    ref = jdiff._tables_for_ts(
        lambda x, t, b: apply({"params": route["params"]}, x, t, b),
        jnp.arange(T, 0, -1), N, jsched.cosine_schedule(T),
        route["jc"].diffusion.exact, grid=grid)
    got = route["kept"][0]
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref).reshape(got.shape),
                               atol=TABLE_ATOL)


def test_n12_deterministic_metrics_equal_jax(route):
    jres, tres = route["jres"], route["tres"]
    for k in ("meas_tv_to_target", "tv_shot_noise_floor"):
        assert tres[k] == pytest.approx(jres[k], abs=1e-6), k
    for k in ("mean_tv_to_target", "mean_marginal_error",
              "classical_fidelity"):
        assert np.isfinite(tres[k]), k
    assert tres["fidelity"] is None and jres["fidelity"] is None


def test_n12_auto_mode_takes_tables_from_2n_shots(route, monkeypatch):
    """``sample_for_bases(mode='auto')`` walks tables at 2^12 shots and
    samples directly one shot below."""
    tres = route["tres"]
    labels = torch.from_numpy(np.asarray(
        jpipe.load_data_cache(route["cache"]).basis_labels, np.int64))
    built = []
    real = tdiff._assembled_tables
    monkeypatch.setattr(tdiff, "_assembled_tables",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    sched = tsched.cosine_schedule(T)
    for shots, tables in ((G, 1), (G - 1, 0)):
        before = len(built)
        out = tdiff.sample_for_bases(torch.Generator().manual_seed(1),
                                     tres["state"], labels, shots, sched,
                                     device="cpu")
        assert out.shape == (BASES, shots, N) and out.dtype == torch.int8
        assert len(built) - before == tables, shots


def test_n12_sample_marginals_follow_jax_exact_chain(route):
    """Per basis and qubit, the samples' marginal lies within 4 noise scales
    (sqrt(p(1-p)/S), at least one shot in S) of JAX's exact chain of the
    same weights; the exact chain sums to 1."""
    labels = jpipe.load_data_cache(route["cache"]).basis_labels
    ref = np.asarray(jdiff.chain_distribution_all_bases(
        _flax_apply(), route["params"], N, jsched.cosine_schedule(T),
        route["jc"].diffusion.exact,
        basis_labels=jnp.asarray(labels, jnp.int32)), np.float64)
    np.testing.assert_allclose(ref.sum(-1), 1.0, atol=1e-4)
    bits = (np.arange(G)[:, None] >> np.arange(N)) & 1
    want = ref @ bits  # [B, N]
    got = route["tres"]["samples"].double().mean(1).numpy()
    scale = np.sqrt(np.maximum(want * (1 - want), 1.0 / SHOTS) / SHOTS)
    z = np.abs(got - want) / scale
    assert (z < 4).all(), z.max()
