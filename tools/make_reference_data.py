#!/usr/bin/env python3
"""Write a scaling rung's seed data with the JAX package, and print the JAX
package's data-side numbers on it.

    JAX_PLATFORMS=cpu python tools/make_reference_data.py --tag rqc6_auto \\
        --out examples/reference_data/rqc6_auto_seed0.npz

The rung's config is ``scripts/run_scaling_ghz.py``'s own (its
``experiments()``). The file is ``ddqst_tpu.pipeline.ensure_data_cache`` at
the seed, in the JAX package's schema (``save_data_cache``), which the
port's ``run_experiment(data_cache=...)`` reads; an existing file is kept.
Then, as ``ddqst_tpu.pipeline.run_experiment`` computes them on that data
and on the CPU: the raw-inversion fidelity (linear inversion of the raw
training counts) and MLE on the raw counts (readout-aware, solved to the
package's tolerance, at most ``--mle-iterations``) with its iteration
count. One JSON line. The npz's arrays are the same at every run; the
zip's timestamps are not, so the file's bytes differ.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import jax.numpy as jnp  # noqa: E402

from ddqst_tpu import pipeline as jpipe  # noqa: E402
from ddqst_tpu.ops import metrics as jM  # noqa: E402
from ddqst_tpu.ops import mle as jmle  # noqa: E402
from ddqst_tpu.ops import pauli as jpauli  # noqa: E402
from ddqst_tpu.ops.complexlib import from_complex  # noqa: E402
from ddqst_tpu.qsim import noise as jnoise  # noqa: E402


def rung_cfg(tag: str):
    """``scripts/run_scaling_ghz.py``'s config of ``tag``."""
    import run_scaling_ghz

    for name, cfg, _ in run_scaling_ghz.experiments():
        if name == tag:
            return cfg
    raise ValueError(f"no rung {tag!r} in scripts/run_scaling_ghz.py")


class CountedSolve:
    """Within the block, every ``ddqst_tpu.ops.mle`` solve records the
    iterations it applied in ``self.iterations`` (the package's own loop,
    ``_run_chunked``, which returns only ρ)."""

    def __enter__(self):
        self.run = jmle._run_chunked
        self.iterations = []

        def counted(step, rho0, f, iterations, tol):
            i, delta, rho = 0, float("inf"), rho0
            while i < iterations and delta > tol:
                i_arr, rho, delta_arr = step(jnp.int32(i), rho, f)
                i, delta = int(i_arr), float(delta_arr)
            self.iterations.append(i)
            return rho

        jmle._run_chunked = counted
        return self

    def __exit__(self, *exc):
        jmle._run_chunked = self.run


def data_side(cfg, data, mle_iterations: int = 4000) -> dict:
    """``ddqst_tpu.pipeline.run_experiment``'s raw baselines on ``data``
    (``ddqst_tpu/pipeline.py:893-912``): the raw-inversion fidelity and MLE
    on the raw counts, with its iteration count and seconds."""
    n = cfg.data.num_qubits
    target = from_complex(data.target)
    raw = jmle.bits_to_counts(data.bits).astype(jnp.float32)
    rho_raw = jpauli.make_counts_inverter(n, data.basis_labels)(raw)
    p = jnoise.get_noise_config(cfg.data.noise_type).readout_p
    t0 = time.perf_counter()
    with CountedSolve() as solve:
        rho = jmle.make_mle(n, data.basis_labels, readout_p=p,
                            iterations=mle_iterations)(raw)
    return dict(raw_fidelity=float(jM.state_fidelity(target, rho_raw)),
                raw_fidelity_mitigated=float(jM.state_fidelity(target, rho)),
                mle_iterations=solve.iterations[0],
                mle_s=time.perf_counter() - t0, readout_p=p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="rqc6_auto")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--mle-iterations", type=int, default=4000)
    args = ap.parse_args(argv)
    cfg = rung_cfg(args.tag)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    t0 = time.perf_counter()
    jpipe.ensure_data_cache(cfg, args.seed, args.out)
    data_s = time.perf_counter() - t0
    data = jpipe.load_data_cache(args.out)
    out = dict(tag=args.tag, seed=args.seed, path=args.out, data_s=data_s,
               bytes=os.path.getsize(args.out),
               **data_side(cfg, data, args.mle_iterations))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
