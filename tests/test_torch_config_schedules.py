"""Port parity: config presets and noise schedules against ddqst_tpu."""

import dataclasses

import numpy as np
import pytest

from ddqst_tpu import config as jcfg
from ddqst_tpu.ops import schedules as jsched
from ddqst_tpu_torch import config as tcfg
from ddqst_tpu_torch.ops import schedules as tsched


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_preset_matches_jax_field_for_field(name):
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
    assert dataclasses.asdict(tcfg.get_preset(name)) == dataclasses.asdict(
        jcfg.get_preset(name)
    )


def test_default_sub_configs_match_jax():
    for cls in ("ModelConfig", "DiffusionConfig", "TrainConfig", "DataConfig"):
        assert dataclasses.asdict(getattr(tcfg, cls)()) == dataclasses.asdict(
            getattr(jcfg, cls)()
        )
    with pytest.raises(ValueError):
        tcfg.DiffusionConfig(schedule="linear", sampler="exact")
    with pytest.raises(ValueError):
        tcfg.get_preset("nope")


@pytest.mark.parametrize("kind", ["linear", "notebook", "cosine"])
@pytest.mark.parametrize("t_steps", [20, 97, 100])
def test_schedule_arrays_match_jax(kind, t_steps):
    """betas and cum_flip agree to 1e-7: both are float32 chains."""
    j = jsched.make_schedule(kind, t_steps)
    t = tsched.make_schedule(kind, t_steps)
    assert t.num_timesteps == j.num_timesteps == t_steps
    assert t.kind == j.kind and t.exact_posterior == j.exact_posterior
    np.testing.assert_allclose(t.betas.numpy(), np.asarray(j.betas), atol=1e-7,
                               rtol=0)
    np.testing.assert_allclose(t.cum_flip.numpy(), np.asarray(j.cum_flip),
                               atol=1e-7, rtol=0)
    if kind != "cosine":  # the one-shot quirk
        np.testing.assert_array_equal(t.cum_flip.numpy(), t.betas.numpy())


def test_unknown_schedule_raises():
    with pytest.raises(ValueError):
        tsched.make_schedule("quadratic", 10)
