"""Where the port's distillation first parts from ``ddqst_tpu``'s, over many
steps, on the CPU: the ``ghz6_auto`` recipe on the JAX package's committed
seed-0 data, at a cut width.

Both packages start from one set of JAX-initialised parameters (with
``--ce-epochs E``, first trained E CE epochs by ``ddqst_tpu``'s own
``run_experiment`` on the file, so the distillation starts at the CE
solution as the recipe's does) and run the recipe's distillation (15% of
the shots held out, the counts target, the 96-basis minibatch) for
``--steps`` steps with the held-out early stop turned off in both
(patience past the last evaluation), so each keeps its whole held-out
history. The port draws JAX's bases: its
``torch.multinomial`` draw is replaced by ``jax.random.choice`` on the keys
``ddqst_tpu.train.finetune_chain`` splits per chunk of
``chain_steps_per_call`` steps. Prints, as one JSON line: both held-out
histories, the step where the per-step losses first differ by more than
``RTOL``, and for each package the step the recipe's patience (4
evaluations without a gain of 1e-5) would have stopped at, and the best
step it would have kept.

    JAX_PLATFORMS=cpu python tools/distill_divergence.py --steps 300 \
        --ce-epochs 10

Run from the root of a checkout. The width is cut to ``WIDTH`` (embed,
hidden, blocks); T = 100 and the data's shapes are the recipe's.

With ``--params PT`` it is a witness at the recipe's own width instead:
both packages start from the port's model in ``PT`` (carried into JAX by
``ddqst_tpu_torch.models.params_to_flax``) and take JAX's own draws (the
rows of ``tools/make_reference_data.py --draws``). It prints, for each
package, the full-grid chain CE and the held-out CE at step 0, the losses
of the steps run, the held-out CE after them, and the largest gap between
the packages, as one JSON line:

    JAX_PLATFORMS=cpu python tools/distill_divergence.py --steps 3 \
        --params examples/reference_params/ghz6_auto_ce2_params.pt

At the ``rqc`` width (128 / 512 / 4) a step costs about 2.5 minutes of 8
CPU cores and a full-grid CE about one minute, so keep ``--steps`` small.
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import jax
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from ddqst_tpu import pipeline as jpipe  # noqa: E402
from ddqst_tpu import train as jtrain  # noqa: E402
from ddqst_tpu.models import build_model as jbuild_model  # noqa: E402
from ddqst_tpu.ops import mle as jmle  # noqa: E402
from ddqst_tpu.ops.schedules import make_schedule as jsched  # noqa: E402
from ddqst_tpu_torch import pipeline as tpipe  # noqa: E402
from ddqst_tpu_torch.campaigns import scaling  # noqa: E402
from ddqst_tpu_torch.models import params_from_flax, params_to_flax  # noqa: E402

import run_scaling_ghz  # noqa: E402

sys.path.insert(0, os.path.join(ROOT, "tools"))
from make_reference_data import recipe_draws  # noqa: E402

TAG, N = "ghz6_auto", 6
DATA = os.path.join(ROOT, "examples", "reference_data", "ghz6_auto_seed0.npz")
PATIENCE, MIN_GAIN = 4, 1e-5  # the recipe's, as finetune_chain applies them
WIDTH = (16, 32, 1)
RTOL = 1e-4


def cut(cfg, args):
    """The recipe with ``--steps`` steps and no early stop; without
    ``--params``, at the cut width."""
    if not args.params:
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, embed_dim=WIDTH[0], hidden_dim=WIDTH[1],
            num_blocks=WIDTH[2]))
    return cfg.replace(train=dataclasses.replace(
        cfg.train, chain_finetune_steps=args.steps,
        chain_val_patience=args.steps + 1))


def patience_stop(history):
    """(the step the recipe's early stop ends at, the best step it keeps)
    on a held-out history ``[(step, ce), ...]``."""
    best_ce, best, bad = history[0][1], history[0][0], 0
    for step, ce in history[1:]:
        if ce < best_ce - MIN_GAIN:
            best_ce, best, bad = ce, step, 0
        else:
            bad += 1
            if bad >= PATIENCE:
                return step, best
    return history[-1][0], best


def witness(args, jlosses, jinfo, tres, seconds: dict) -> dict:
    """``--params``' record: each package's step-0 CEs, losses and
    held-out CE after the last step, and the largest gap between the
    packages."""
    def numbers(losses, info):
        hist = [float(c) for _, c in info["val_history"]]
        return dict(chain_ce_step0=float(info["train_ce_before"]),
                    val_ce_step0=hist[0],
                    losses=[float(v) for v in np.asarray(losses)],
                    val_ce_after=hist[-1])

    both = {"jax": numbers(jlosses, jinfo),
            "port": numbers(tres["ft_losses"], tres["ft_info"])}

    def flat(d):
        return [d["chain_ce_step0"], d["val_ce_step0"], *d["losses"],
                d["val_ce_after"]]

    j, p = (np.asarray(flat(both[k])) for k in ("jax", "port"))
    return dict(tag=TAG, params=os.path.relpath(args.params, ROOT),
                draws="jax_seed0", steps=args.steps,
                width="recipe", **both,
                max_abs_gap=float(np.abs(p - j).max()),
                max_rel_gap=float((np.abs(p - j) / np.abs(j)).max()),
                seconds=seconds, torch_threads=torch.get_num_threads(),
                cpu_count=os.cpu_count(), jax_version=jax.__version__,
                torch_version=torch.__version__)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ce-epochs", type=int, default=0)
    ap.add_argument("--params", default="",
                    help="the port's model to start both packages from, at "
                    "the recipe's width")
    args = ap.parse_args(argv)
    if args.params and args.ce_epochs:
        ap.error("--params starts from a model; --ce-epochs trains one")
    torch.set_num_threads(os.cpu_count())

    jc = cut(next(c for t, c, _ in run_scaling_ghz.experiments()
                  if t == TAG), args)
    tc = cut(scaling.experiment(TAG)[0], args)
    tr = jc.train
    t_steps = jc.diffusion.num_timesteps
    data = jpipe.load_data_cache(DATA)
    _, k_train, _ = jax.random.split(jax.random.key(0), 3)
    state = jtrain.create_state(k_train, jbuild_model(jc.model, N, t_steps),
                                jc.train, N)
    tmp_dir = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    if args.ce_epochs:
        from ddqst_tpu.utils import checkpoint as jckpt

        ce_path = os.path.join(tmp_dir.name, "ce")
        jpipe.run_experiment(
            jc.replace(train=dataclasses.replace(
                jc.train, num_epochs=args.ce_epochs, chain_finetune_steps=0)),
            seed=0, data_cache=DATA, params_save=ce_path,
            stop_after="distill", log_fn=lambda m: None)
        state = state.replace(params=jckpt.restore_params(ce_path,
                                                          state.params))
    if args.params:
        state = state.replace(params=jax.tree_util.tree_map(
            jax.numpy.asarray, params_to_flax(torch.load(
                args.params, map_location="cpu", weights_only=True))))
    ce_s = time.perf_counter() - t0

    # JAX: run_experiment's held-out split and distillation call.
    key = jax.random.fold_in(k_train, 0xD157 + tr.chain_key_salt)
    s = data.bits.shape[1]
    s_val = min(max(int(round(tr.chain_val_fraction * s)), 1), s - 1)
    t0 = time.perf_counter()
    _, jlosses, jinfo = jtrain.finetune_chain(
        state, jmle.bits_to_counts(data.bits[:, :s - s_val]),
        jsched(jc.diffusion.schedule, t_steps), N, steps=args.steps,
        learning_rate=tr.chain_lr, exact=jc.diffusion.exact,
        basis_batch=tr.chain_basis_batch, key=key,
        steps_per_call=tr.chain_steps_per_call,
        val_counts=jmle.bits_to_counts(data.bits[:, s - s_val:]),
        val_patience=args.steps + 1, accum=tr.chain_accum,
        hard_frac=tr.chain_hard_frac)
    jax_s = time.perf_counter() - t0

    # JAX's draws, chunk by chunk as finetune_chain makes them.
    draws = list(recipe_draws(jc, seed=0))

    def multinomial(p, num, replacement=False, generator=None):
        assert num == tr.chain_basis_batch and not replacement
        return torch.from_numpy(draws.pop(0).astype(np.int64))

    with tmp_dir:
        ppath = args.params or os.path.join(tmp_dir.name, "params.pt")
        if not args.params:
            torch.save(params_from_flax(
                jax.tree_util.tree_map(np.asarray, state.params)), ppath)
        own = torch.multinomial
        torch.multinomial = multinomial
        t0 = time.perf_counter()
        try:
            tres = tpipe.run_experiment(tc, seed=0, data_cache=DATA,
                                        params_load=ppath,
                                        stop_after="distill", device="cpu",
                                        log_fn=lambda m: None)
        finally:
            torch.multinomial = own
        port_s = time.perf_counter() - t0
    if draws:
        raise RuntimeError(f"{len(draws)} of JAX's draws were not used")

    if args.params:
        print(json.dumps(witness(args, jlosses, jinfo, tres, dict(
            jax=jax_s, port=port_s))), flush=True)
        return 0
    jl, pl = np.asarray(jlosses, np.float64), np.asarray(tres["ft_losses"])
    rel = np.abs(pl - jl) / np.abs(jl)
    apart = np.nonzero(rel > RTOL)[0]
    jh = [(int(k), float(c)) for k, c in jinfo["val_history"]]
    ph = [(int(k), float(c)) for k, c in tres["ft_info"]["val_history"]]
    out = dict(
        tag=TAG, steps=args.steps, ce_epochs=args.ce_epochs,
        width=list(WIDTH),
        losses_first_apart=int(apart[0]) + 1 if apart.size else None,
        losses_max_rel=float(rel.max()), rtol=RTOL,
        val_history={"jax": jh, "port": ph},
        val_max_rel=max(abs(a[1] - b[1]) / abs(a[1]) for a, b in zip(jh, ph)),
        patience_stop={"jax": patience_stop(jh), "port": patience_stop(ph)},
        chain_ce={"jax": [jinfo["train_ce_before"], jinfo["train_ce_after"]],
                  "port": [tres["ft_info"]["train_ce_before"],
                           tres["ft_info"]["train_ce_after"]]},
        seconds={"ce": ce_s, "jax": jax_s, "port": port_s})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
