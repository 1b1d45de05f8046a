"""The per-basis excess KL of N=10 shadow snapshots: the counterpart of
``scripts/shadow_sector_profile.py``.

    python -m ddqst_tpu_torch.campaigns.shadow_sector_profile SNAP.pt
        [SNAP.pt ...] --data NPZ [--bases R] [--chunk C] [--val_fraction F]
        [--seed S] [--embed D --hidden H --blocks B --heads A]
        [--timesteps T] [--schedule NAME] [--out FILE] [--device cuda|cpu]

Does the N=10 shadow route's residual concentrate in a subset of the bases,
as GHZ-8's did in its all-X/Y bases? This reads a campaign's data cache
(``pipeline.load_data_cache``: the bits, basis labels and clean Born
probabilities), draws ``--bases`` of its bases with ``default_rng(--seed)``
(0: all of them), computes each snapshot's exact chain distribution there
(``ops.diffusion.chain_distribution`` conditioned on the label rows,
``--chunk`` bases a forward) and writes one row a basis:

- ``kl_clean``: KL(clean Born probabilities || chain), the residual free of
  shot noise;
- ``kl_counts``: CE(counts, chain) - H(counts) on the train share of the
  shots (the first ``S - round(val_fraction·S)``, at least 1 held out and 1
  kept), what the distillation loss sees;
- ``n_z``: the number of Z labels in the basis.

Rows have the script's keys (``snap``, ``basis``, ``n_z``, ``kl_clean``,
``kl_counts``) and ``device``, appended to ``--out``; a summary line a
snapshot gives the quantiles of ``kl_clean`` and the top-5 bases. The
model is the transformer denoiser of the flags (the segment campaign's
defaults); snapshots are ``torch.save`` state dicts.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ddqst_tpu_torch.campaigns import RESULTS_DIR, append_row, device_label

DEFAULT_OUT = os.path.join(RESULTS_DIR, "shadow_sector_profile.jsonl")


def select(num_bases: int, bases: int, seed: int) -> np.ndarray:
    """The sorted rows of the cache to profile (all when ``bases`` is 0 or
    not below ``num_bases``)."""
    if bases and bases < num_bases:
        return np.sort(np.random.default_rng(seed).choice(
            num_bases, size=bases, replace=False))
    return np.arange(num_bases)


def train_freqs(bits: np.ndarray, val_fraction: float) -> np.ndarray:
    """Outcome frequencies ``[B, 2^N]`` (float64) of each basis' train
    share of the shots."""
    from ddqst_tpu_torch.ops.mle import bits_to_counts

    s = bits.shape[1]
    s_val = min(max(int(round(val_fraction * s)), 1), s - 1)
    counts = bits_to_counts(torch.from_numpy(
        np.ascontiguousarray(bits[:, :s - s_val]))).double().numpy()
    return counts / counts.sum(-1, keepdims=True)


def clean_rows(data) -> np.ndarray:
    """A data cache's clean Born probabilities in float64, each row
    normalised."""
    clean = np.asarray(data.clean_probs, np.float64)
    return clean / clean.sum(-1, keepdims=True)


def kl_rows(p_rows: np.ndarray, q_rows: np.ndarray) -> np.ndarray:
    """KL(p || q) a row, q floored at 1e-12 as the distillation loss
    floors it."""
    q = np.maximum(q_rows, 1e-12)
    p = np.maximum(p_rows, 0.0)
    return np.where(p > 0, p * (np.log(np.maximum(p, 1e-300)) - np.log(q)),
                    0.0).sum(-1)


def chain_dists(model: torch.nn.Module, schedule, num_qubits: int,
                labels: np.ndarray, chunk: int,
                log_fn=None) -> np.ndarray:
    """The exact chain distribution ``[len(labels), 2^N]`` (float64, rows
    normalised) conditioned on each label row, ``chunk`` rows a forward."""
    from ddqst_tpu_torch.ops.diffusion import chain_distribution

    dev = schedule.betas.device
    dist = np.zeros((len(labels), 2**num_qubits), np.float64)
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(0, len(labels), chunk):
            lab = torch.as_tensor(labels[i:i + chunk], dtype=torch.int64,
                                  device=dev)
            d = chain_distribution(model, num_qubits, schedule, False,
                                   basis_labels=lab)
            dist[i:i + len(lab)] = d.double().cpu().numpy()
            if log_fn is not None:
                log_fn(f"{i + len(lab)}/{len(labels)} bases "
                       f"[{time.perf_counter() - t0:.0f}s]")
    return dist / dist.sum(-1, keepdims=True)


def basis_rows(snap: str, sel: np.ndarray, labels: np.ndarray,
               clean: np.ndarray, freqs: np.ndarray,
               dist: np.ndarray) -> tuple[list[dict], np.ndarray]:
    """One row a selected basis, and ``kl_clean`` of each: ``clean``,
    ``freqs`` and ``labels`` index the cache's rows, ``dist`` the
    selection's."""
    klc = kl_rows(clean[sel], dist)
    f = freqs[sel]
    ent = -np.where(f > 0, f * np.log(np.maximum(f, 1e-300)), 0.0).sum(-1)
    kln = -(f * np.log(np.maximum(dist, 1e-12))).sum(-1) - ent
    n_z = (labels[sel] == 2).sum(-1)
    rows = [{"snap": snap, "basis": int(b), "n_z": int(n_z[j]),
             "kl_clean": round(float(klc[j]), 6),
             "kl_counts": round(float(kln[j]), 6)}
            for j, b in enumerate(sel)]
    return rows, klc


def summary(snap: str, sel: np.ndarray, klc: np.ndarray) -> str:
    """The script's summary line of one snapshot."""
    qs = np.quantile(klc, [0.5, 0.9, 0.99])
    top = sel[np.argsort(klc)[-5:]][::-1]
    share = (np.sort(klc)[-max(1, len(sel) // 10):].sum()
             / max(klc.sum(), 1e-12))
    return (f"[profile] {snap}: mean KL(clean||chain) {klc.mean():.5f} "
            f"(median {qs[0]:.5f}, p90 {qs[1]:.5f}, p99 {qs[2]:.5f}); "
            f"top-5 bases {top.tolist()}; share in top 10% of bases "
            f"{share:.2f}")


def build_model(args: argparse.Namespace, num_qubits: int,
                device: torch.device) -> torch.nn.Module:
    from ddqst_tpu_torch.config import ModelConfig
    from ddqst_tpu_torch.models import build_model as build

    mcfg = ModelConfig(arch="transformer", input_encoding="token",
                       embed_dim=args.embed, hidden_dim=args.hidden,
                       num_blocks=args.blocks, num_heads=args.heads)
    return build(mcfg, num_qubits, args.timesteps).to(device)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m ddqst_tpu_torch.campaigns.shadow_sector_profile",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("snaps", nargs="+", help="torch.save params snapshots")
    ap.add_argument("--data", required=True,
                    help="the campaign's data cache npz")
    ap.add_argument("--bases", type=int, default=48,
                    help="random basis subset size (0 = every cached basis)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="bases a chain forward")
    ap.add_argument("--val_fraction", type=float, default=0.15,
                    help="the campaign's held-out split (kl_counts is on "
                    "the train share)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--embed", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--timesteps", type=int, default=100)
    ap.add_argument("--schedule", default="cosine")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, log_fn=print,
        limit: int | None = None) -> list[dict]:
    """Every snapshot's rows, appended to ``args.out`` and returned;
    ``limit`` keeps the selection's first ``limit`` bases (a cut for
    tests)."""
    from ddqst_tpu_torch import pipeline
    from ddqst_tpu_torch.device import resolve_device
    from ddqst_tpu_torch.ops.schedules import make_schedule
    from ddqst_tpu_torch.utils.checkpoint import restore_params

    device = resolve_device(args.device)
    data = pipeline.load_data_cache(args.data)
    labels = np.asarray(data.basis_labels)
    clean = clean_rows(data)
    bits = data.bits.numpy()
    b_all, _, n = bits.shape
    freqs = train_freqs(bits, args.val_fraction)
    sel = select(b_all, args.bases, args.seed)[:limit]
    schedule = make_schedule(args.schedule, args.timesteps, device)
    model = build_model(args, n, device)
    label = device_label(device)
    out = []
    for snap in args.snaps:
        restore_params(os.path.abspath(snap), model).eval()
        dist = chain_dists(model, schedule, n, labels[sel], args.chunk,
                           lambda m: log_fn(f"[profile] {snap}: {m}"))
        rows, klc = basis_rows(snap, sel, labels, clean, freqs, dist)
        for rec in rows:
            rec["device"] = label
            append_row(args.out, rec)
        log_fn(summary(snap, sel, klc))
        out += rows
    return out


def main(argv: list[str] | None = None) -> int:
    run(parse_args(argv), log_fn=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
