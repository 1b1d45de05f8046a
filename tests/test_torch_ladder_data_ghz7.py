"""The GHZ-7 rung's committed seed-0 data
(``examples/reference_data/ghz7_mle_hot_seed0.npz``, 2,187 bases x 3,000
shots) against the JAX package: ``test_torch_ladder_data.py``'s four tests
on ``ghz7_mle_hot``, in a file of its own so that the test run spreads it
to another worker than RQC-5's and GHZ-6's. MLE on the raw counts is
capped at 5 iterations: at N = 7 an iteration takes about 5 s in JAX and
18 s in the port on one CPU thread.
"""

import pytest

from test_torch_ladder_data import (  # noqa: F401  (collected here too)
    make_rung, test_chip_smoke_rung_is_the_scripts,
    test_committed_data_is_a_fresh_jax_cache, test_mle_on_raw_capped_matches_jax,
    test_port_reads_the_same_counts_and_raw_inversion)

MLE_ITERS = 5


@pytest.fixture(scope="module")
def rung(tmp_path_factory):
    return make_rung("ghz7_mle_hot", tmp_path_factory, mle_iters=MLE_ITERS)
