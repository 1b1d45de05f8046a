"""The port's GHZ-5 distillation diagnostics (``campaigns.diag_segment_descent``,
``diag_floor_escape``, ``diag_hard_mining``) against
``scripts/diag_*.py`` on the CPU: the deterministic parts on the JAX
package's data (the scripts' ``make_cfg`` and data at seed 0), with one set
of JAX-initialised params (moved off the initialiser's zero head by seeded
noise) converted through ``models.params_from_flax``.

- the config: ``recipes.diag_cfg`` equals each script's ``make_cfg``;
- the floor (the counts' mean entropy) equals the script's;
- one ``full``-arm step (``accum=9999``, clamped to 60 minibatches of 4 of
  the 243 bases in both packages; the port handed JAX's draw): the chain CE
  before and after within ``CE_TOL``;
- ``diag_hard_mining``'s MLE target within ``TARGET_TOL`` of the script's,
  and its ``profile()`` (full-grid mean, Z-sector and max excess) within
  ``CE_TOL`` on the script's target;
- each driver's record, at a cut depth on GHZ-2, has the JAX record's keys
  and ``device``.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddqst_tpu import pipeline as jpipe
from ddqst_tpu import train as jtrain
from ddqst_tpu.models import build_model as jbuild_model
from ddqst_tpu.ops import mle as jmle
from ddqst_tpu.ops.complexlib import CArray, from_complex
from ddqst_tpu.ops.diffusion import chain_distribution as jchain
from ddqst_tpu.ops.schedules import make_schedule as jmake_schedule
from ddqst_tpu.qsim import measure as jmeasure
from ddqst_tpu_torch.campaigns import (diag, diag_floor_escape,
                                       diag_hard_mining, diag_segment_descent)
from ddqst_tpu_torch.campaigns.recipes import diag_cfg
from ddqst_tpu_torch.models import build_model, params_from_flax
from ddqst_tpu_torch.ops.mle import bits_to_counts
from ddqst_tpu_torch.ops.schedules import make_schedule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import diag_floor_escape as j_escape  # noqa: E402
import diag_hard_mining as j_mining  # noqa: E402
import diag_segment_descent as j_descent  # noqa: E402

torch.set_num_threads(4)

CE_TOL = 1e-5
TARGET_TOL = 1e-4
DRIVERS = {"diag_segment_descent": (diag_segment_descent, j_descent),
           "diag_floor_escape": (diag_floor_escape, j_escape),
           "diag_hard_mining": (diag_hard_mining, j_mining)}


@pytest.fixture(scope="module")
def jdata():
    """The scripts' data: ``make_cfg()``'s GHZ-5 at seed 0."""
    cfg = j_escape.make_cfg()
    k_data, _, _ = jax.random.split(jax.random.key(0), 3)
    return cfg, jpipe.generate_training_data(cfg, k_data,
                                             np.random.default_rng(0))


@pytest.fixture(scope="module")
def params(jdata):
    """JAX-initialised params of the diagnostics' model, with seeded
    noise: the flax tree and the port's model."""
    cfg, _ = jdata
    state = jtrain.create_state(jax.random.key(1),
                                jbuild_model(cfg.model, 5, 100), cfg.train, 5)
    rng = np.random.default_rng(2)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            np.shape(x)).astype(np.float32), state.params)
    pcfg = diag_cfg(diag_floor_escape.NAME)
    model = build_model(pcfg.model, 5, 100)
    model.load_state_dict(params_from_flax(tree))
    return state.replace(params=jax.tree_util.tree_map(jnp.asarray, tree)), \
        model.eval()


@pytest.mark.parametrize("name", list(DRIVERS))
def test_diag_cfg_is_the_scripts_make_cfg(name):
    port, script = DRIVERS[name]
    assert dataclasses.asdict(diag_cfg(port.NAME)) == dataclasses.asdict(
        script.make_cfg())


def test_floor_matches_the_script(jdata):
    _, data = jdata
    target = np.asarray(jmle.bits_to_counts(data.bits), np.float64)
    tgt = target / target.sum(-1, keepdims=True)
    want = float(np.mean(-np.sum(tgt * np.log(np.maximum(tgt, 1e-300)),
                                 axis=-1)))
    bits = torch.from_numpy(np.array(data.bits))
    got = diag_floor_escape.entropy_floor(bits_to_counts(bits))
    assert abs(got - want) <= 1e-12, (got, want)
    assert 2.5 < got < 3.5  # the record's floors: 2.859, 2.916


def test_full_arm_step_matches_jax_and_clamps_accum(jdata, params,
                                                    monkeypatch):
    """One step at ``accum=9999``: 60 minibatches of 4 bases (240 of 243),
    the port given JAX's draw; the chain CE before and after."""
    jcfg, data = jdata
    jstate, model = params
    target = np.asarray(jmle.bits_to_counts(data.bits), np.float64)
    key = jax.random.fold_in(jax.random.key(0), diag_floor_escape.SALT + 4)
    shapes = []
    choice = jax.random.choice

    def spy_choice(k, a, shape=(), *args, **kw):
        shapes.append(tuple(shape))
        return choice(k, a, shape, *args, **kw)

    monkeypatch.setattr(jax.random, "choice", spy_choice)
    _, _, want = jtrain.finetune_chain(
        jstate, target, jmake_schedule("cosine", 100), 5, steps=1,
        learning_rate=diag.LR, exact=jcfg.diffusion.exact,
        basis_batch=diag.BASIS_BATCH, key=key, steps_per_call=5,
        accum=9999)
    monkeypatch.undo()
    assert shapes == [(60, 4)]
    ks = jax.random.split(jax.random.fold_in(key, 0), 1)[0]
    sel = np.asarray(choice(ks, 243, (60, 4), replace=False)).reshape(-1)
    drawn = []

    def fake_multinomial(p, num_samples, replacement=False, generator=None):
        drawn.append((p.shape[0], num_samples, replacement))
        return torch.from_numpy(sel.astype(np.int64))

    monkeypatch.setattr(torch, "multinomial", fake_multinomial)
    cfg = diag_cfg(diag_floor_escape.NAME)
    dev = torch.device("cpu")
    _, _, got = diag.distill(model, torch.from_numpy(target),
                             make_schedule("cosine", 100, dev), cfg, dev,
                             steps=1, salt=diag_floor_escape.SALT + 4,
                             accum=9999)
    assert drawn == [(243, 240, False)]
    for k in ("train_ce_before", "train_ce_after"):
        assert abs(got[k] - want[k]) <= CE_TOL, (k, got[k], want[k])
    assert want["train_ce_before"] - want["train_ce_after"] > 1e-4


def test_hard_mining_target_and_profile_match_the_script(jdata, params):
    jcfg, data = jdata
    jstate, model = params
    counts = jmle.bits_to_counts(data.bits)
    rho = jmle.make_mle(5, data.basis_labels)(jnp.asarray(counts,
                                                          jnp.float32))
    rots = from_complex(jmeasure.rotation_unitaries(data.basis_labels))
    target = np.asarray(jmeasure.batched_probs_mixed(
        CArray(rho.re[None], rho.im[None]), rots)[0], np.float64)
    target = target / target.sum(-1, keepdims=True)
    got_target = diag_hard_mining.mle_target(
        torch.from_numpy(np.array(data.bits)), data.basis_labels)
    np.testing.assert_allclose(got_target, target, atol=TARGET_TOL, rtol=0)

    ent = -np.sum(target * np.log(np.maximum(target, 1e-300)), axis=-1)
    low = np.argsort(ent)[: max(len(ent) // 10, 1)]
    np.testing.assert_array_equal(diag_hard_mining.z_decile(target), low)
    dist = jchain(lambda x, t, b: jstate.apply_fn(
        {"params": jstate.params}, x, t, b), 5, jmake_schedule("cosine", 100),
        jcfg.diffusion.exact, basis_idx=jnp.arange(243, dtype=jnp.int32))
    exc = np.asarray(-jnp.sum(jnp.asarray(target, jnp.float32)
                              * jnp.log(jnp.maximum(dist, 1e-12)), axis=-1),
                     np.float64) - ent
    want = {"mean": float(exc.mean()), "zsector": float(exc[low].mean()),
            "max": float(exc.max())}
    cfg = diag_cfg(diag_hard_mining.NAME)
    got = diag_hard_mining.profile(
        model, make_schedule("cosine", 100, torch.device("cpu")), cfg,
        target, low)
    for k in want:
        assert abs(got[k] - want[k]) <= CE_TOL, (k, got[k], want[k])
    assert want["max"] > want["mean"] > 1e-3


@pytest.mark.parametrize("name,depth", [
    ("diag_segment_descent", dict(steps=2)),
    ("diag_floor_escape", dict(steps=6, warm=1)),
    ("diag_hard_mining", dict(steps=2, warm=1)),
])
def test_driver_record_has_the_jax_keys(name, depth, tmp_path):
    """GHZ-2 (9 bases: accum 4 clamps to 2), one CE epoch, the arms cut to
    ``depth`` (``floor_escape``'s ``full`` arm 0 steps, its ``avg`` arm 6
    chunks of 1)."""
    port, _ = DRIVERS[name]
    dev = torch.device("cpu")
    data, g_train = diag.make_data(diag_cfg(port.NAME, num_qubits=2), dev)
    results = port.run(data.bits, data.basis_idx, device=dev,
                       generator=g_train, epochs=1, log_fn=lambda m: None,
                       **depth)
    path = diag.write_record(str(tmp_path / f"{name}.json"), results, dev)
    with open(path) as f:
        got = json.load(f)
    with open(os.path.join(ROOT, "examples", f"{name}.json")) as f:
        want = json.load(f)
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    for k, v in want.items():
        if isinstance(v, dict):
            assert set(got[k]) == set(v), k
            for inner, x in v.items():
                assert np.all(np.isfinite(got[k][inner])), (k, inner)
                assert np.shape(got[k][inner]) == np.shape(x), (k, inner)
        else:
            assert np.isfinite(got[k]), k
