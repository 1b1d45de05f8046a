"""The campaign drivers of the JAX package's ``scripts/``, on the port.

Each module is the counterpart of one script, runnable as ``python -m
ddqst_tpu_torch.campaigns.<name>``, with the script's flags where a flag
means something on a GPU, plus ``--device`` (default ``cuda``; without CUDA
a run raises unless given ``--device cpu``). Rows keep the script's JSON
schema and add ``device``: the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them, or
``"cpu"``. They go to the port's own records under
``examples/results_torch/``, never to the JAX package's.

- ``recipes``: ``quality_cfg`` (``scripts/run_parity_suite.py``),
  ``coverage_steps`` and ``auto_recipe`` (``scripts/run_scaling_ghz.py``);
- ``scaling``: the scaling ladder (``scripts/run_scaling_ghz.py``);
- ``shadow_scale``: the N=10 shadow runs (``scripts/run_shadow_scale.py``);
- ``segments``: segmented distillation, each role a fresh child process
  (``scripts/run_frontier_segments.py``).
"""

from __future__ import annotations

import json
import os

import torch

# The port's records of campaign rows (the JAX package's stay in
# examples/results_*.jsonl).
RESULTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "examples", "results_torch")


def device_label(device: torch.device) -> str:
    """A row's ``device``: on a card its ``nvidia-smi`` name and power
    limit, else the device type."""
    if device.type != "cuda":
        return device.type
    from ddqst_tpu_torch.bench import device_info

    return device_info(device)["nvidia_smi"]


def read_rows(path: str) -> list[dict]:
    """The rows of a record file (none if it does not exist)."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def append_row(path: str, rec: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
