"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

- ``fused_chain_walk`` replaces the TPU kernel
  ``ddqst_tpu/ops/pallas_kernels.py::fused_chain_walk``: the whole T-step
  reverse table walk of the grid sampler in one launch
  (``csrc/chain_walk.cu``).
- ``fused_chain_step`` replaces ``pallas_kernels.py::fused_chain_step``: one
  reverse step of the grid sampler, a table gather and one Bernoulli draw
  per bit for every chain (``csrc/chain_step.cu``). With ``row_base`` it
  takes the chain state and adds each chain's row offset itself, so a walk
  of T steps makes no pass over the chains between its launches.

Beside each, ``*_reference`` is the same function with the same
Philox4x32-10 words (``csrc/philox.cuh``), computed with tensor ops.

A wrapper takes the plain version only for tensors that lie on the CPU
(that is what the CPU tests exercise). For CUDA tensors it launches the
kernel or raises; nothing falls back. ``<wrapper>.launches`` counts kernel
launches (never plain-version calls), so a run can show that its main path
went through the kernel. Within a ``StepTimer`` block every launch of
``fused_chain_step`` is also timed by a CUDA event pair on its stream.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ddqst_tpu_torch.ops import _build

# Philox4x32-10 constants (Salmon et al., SC'11; Random123).
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
# The walk kernel's largest N: up to 7 it stages a block's table slices in
# shared memory, from 8 to 11 it lands them in a ring of shared-memory
# stages, and from 12 to 16 it gathers each chain's row from global memory
# (csrc/chain_walk.cu).
_MAX_WALK_N = 16


def _mulhilo(m: int, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of ``m * a`` for uint32 values held in int64.

    The full 64-bit product overflows signed int64, so ``m`` is split into
    16-bit limbs: every partial product stays below 2^49.
    """
    p0 = a * (m & 0xFFFF)
    mid = a * (m >> 16) + (p0 >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p0 & 0xFFFF)


def philox4x32_10(ctr, key: tuple[int, int]):
    """Philox4x32-10 on counters ``ctr = (c0, c1, c2, c3)`` (int64 tensors
    holding uint32 values, broadcastable) under ``key = (k0, k1)``.

    Returns the four uint32 output words as int64 tensors.
    """
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _on_cpu(t: torch.Tensor) -> bool:
    """Whether a wrapper takes its plain version: only for CPU tensors."""
    return t.device.type == "cpu"


def _check_walk_args(seed, tables, init, num_qubits) -> None:
    if not isinstance(seed, int) or not 0 <= seed < 2**64:
        raise ValueError(f"seed must be an int in [0, 2^64), got {seed!r}")
    if tables.dtype != torch.float32 or tables.dim() != 4:
        raise ValueError(
            f"tables must be [T, C, 2^N, N] float32, got {tuple(tables.shape)} "
            f"{tables.dtype}"
        )
    t_steps, c, g, n = tables.shape
    if n != num_qubits or g != 2**num_qubits:
        raise ValueError(
            f"tables shape {tuple(tables.shape)} does not match N={num_qubits}"
        )
    if init.dtype != torch.int32 or init.dim() != 2 or init.shape[0] != c:
        raise ValueError(
            f"init must be [C={c}, S] int32, got {tuple(init.shape)} {init.dtype}"
        )
    if init.device != tables.device:
        raise ValueError(
            f"tables on {tables.device} but init on {init.device}"
        )
    if t_steps < 1 or init.shape[1] < 1:
        raise ValueError("need T >= 1 steps and S >= 1 chains")


def fused_chain_walk_reference(
    seed: int, tables: torch.Tensor, init: torch.Tensor, num_qubits: int
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same walk, the same bits.

    ``tables [T, C, 2^N, N]`` float32 (index 0 is t = T), ``init [C, S]``
    int32, 64-bit ``seed``; returns ``[C, S]`` int32. Step i draws, for
    chain (c, s), the Philox4x32-10 block with counter (s, c, i, q // 4)
    and key (seed mod 2^32, seed >> 32); bit q uses word q % 4 and
    ``u = (word >> 8) * 2^-24``.
    """
    _check_walk_args(seed, tables, init, num_qubits)
    t_steps, c, g, n = tables.shape
    s = init.shape[1]
    dev = tables.device
    key = (seed & _MASK32, seed >> 32)
    s_idx = torch.arange(s, device=dev, dtype=torch.int64).expand(c, s)
    c_idx = torch.arange(c, device=dev, dtype=torch.int64)[:, None].expand(c, s)
    row_base = c_idx * g
    flat = tables.reshape(t_steps, c * g, n)
    x = init.to(torch.int64)
    for i in range(t_steps):
        p1 = flat[i][row_base + x]  # [C, S, N]
        nx = torch.zeros_like(x)
        for qb in range((n + 3) // 4):
            words = philox4x32_10(
                (s_idx, c_idx, torch.full_like(s_idx, i),
                 torch.full_like(s_idx, qb)),
                key,
            )
            for k in range(min(4, n - 4 * qb)):
                q = 4 * qb + k
                u = (words[k] >> 8).to(torch.float32) * (1.0 / 16777216.0)
                nx |= (u < p1[..., q]).to(torch.int64) << q
        x = nx
    return x.to(torch.int32)


@functools.cache
def _chain_walk_fn():
    fn = _build.load("chain_walk").ddqst_fused_chain_walk
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # tables, init, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # T, C, g, N
        ctypes.c_int,  # S
        ctypes.c_uint64,  # seed
        ctypes.c_int,  # threads (0 = chosen from the shape)
        ctypes.c_void_p,  # plan_out: int[4] or null
        ctypes.c_void_p,  # stream
    ]
    return fn


# The walk's bodies, as the kernel's plan numbers them (csrc/chain_walk.cu).
_WALK_BODY_NAMES = {1: "staged", 2: "ring", 3: "gather"}


def fused_chain_walk(
    seed: int, tables: torch.Tensor, init: torch.Tensor, num_qubits: int,
    *, threads: int = 0,
) -> torch.Tensor:
    """Run the whole T-step reverse chain walk in one CUDA kernel launch.

    Args:
      seed: 64-bit int; the Philox key.
      tables: ``[T, C, 2^N, N]`` float32 P(bit=1) per (step, conditioning
        row, current outcome); index 0 = the first reverse step (t = T).
      init: ``[C, S]`` int32 initial outcome indices.
      num_qubits: N, with 1 <= N <= 16. N chooses one of three bodies,
        which give the same bits: up to N = 7 a block stages its step
        slices in shared memory; from 8 to 11 each step's ``[2^N, N]``
        slice lands once a block in a ring of shared-memory stages (bulk
        copies, 40 KB a step at N = 10), from which each chain reads its N
        probabilities; from 12 on (a slice of 192 KB or more, too large to
        double-buffer in a block's 227 KB) the gather body: each chain reads
        its row from global memory in the widest loads its alignment
        allows, one block of up to 1,024 of a row's chains an SM, so that
        the SM's L1 keeps that row's step slice.
      threads: the kernel's block size: 0 (chosen from the shape) or 64,
        128, 256 or 512, for measurements. The result does not depend on it
        (the Philox counter is the chain's index), and the plain version
        ignores it.

    Returns:
      ``[C, S]`` int32 final outcome indices (samples of x_0).

    CPU tensors take :func:`fused_chain_walk_reference`; CUDA tensors launch
    the kernel on the current stream, or raise: a shape the card cannot
    place raises, and no other body is tried. After a launch,
    ``fused_chain_walk.last_plan`` holds what the kernel chose: ``(threads a
    block, steps a shared-memory buffer, shared-memory bytes, body)``, body
    ``'staged'``, ``'ring'`` or ``'gather'``; the gather body stages nothing
    (0 steps) and reports the shared memory it reserves, unused, to hold an
    SM to one block.
    """
    _check_walk_args(seed, tables, init, num_qubits)
    if threads not in (0, 64, 128, 256, 512):
        raise ValueError(f"threads must be 0, 64, 128, 256 or 512, got {threads}")
    if _on_cpu(tables):
        return fused_chain_walk_reference(seed, tables, init, num_qubits)
    t_steps, c, g, n = tables.shape
    if n > _MAX_WALK_N:
        raise ValueError(
            f"the CUDA walk takes N <= {_MAX_WALK_N} (2^N <= {2**_MAX_WALK_N}),"
            f" got N={n}")
    if c > 65535:
        raise ValueError(f"the CUDA walk takes at most 65,535 rows, got {c}")
    if tables.device.type != "cuda":
        raise ValueError(f"unsupported device {tables.device}")
    if not (tables.is_contiguous() and init.is_contiguous()):
        raise ValueError("tables and init must be contiguous")
    s = init.shape[1]
    out = torch.empty_like(init)
    fn = _chain_walk_fn()
    plan = (ctypes.c_int * 4)()
    stream = torch.cuda.current_stream(tables.device).cuda_stream
    with torch.cuda.device(tables.device):
        err = fn(tables.data_ptr(), init.data_ptr(), out.data_ptr(),
                 t_steps, c, g, n, s, seed, threads,
                 ctypes.addressof(plan), stream)
    if err != 0:
        raise RuntimeError(f"chain_walk kernel launch failed: cudaError {err}")
    fused_chain_walk.launches += 1
    fused_chain_walk.last_plan = (plan[0], plan[1], plan[2],
                                  _WALK_BODY_NAMES[plan[3]])
    return out


fused_chain_walk.launches = 0
fused_chain_walk.last_plan = None


_MAX_STEP_N = 30  # the outcome index holds N bits in an int32


def _check_step_args(seed, table, rows, num_qubits, step,
                     row_base=None) -> None:
    if not isinstance(seed, int) or not 0 <= seed < 2**64:
        raise ValueError(f"seed must be an int in [0, 2^64), got {seed!r}")
    if not isinstance(step, int) or not 0 <= step < 2**32:
        raise ValueError(f"step must be an int in [0, 2^32), got {step!r}")
    if not 1 <= num_qubits <= _MAX_STEP_N:
        raise ValueError(f"need 1 <= N <= {_MAX_STEP_N}, got {num_qubits}")
    if (table.dtype != torch.float32 or table.dim() != 2
            or table.shape[1] != num_qubits):
        raise ValueError(
            f"table must be [G, N={num_qubits}] float32, got "
            f"{tuple(table.shape)} {table.dtype}"
        )
    if not 1 <= table.shape[0] < 2**31:
        raise ValueError(f"need 1 <= G < 2^31 table rows, got {table.shape[0]}")
    if rows.dtype != torch.int32 or rows.dim() != 1:
        raise ValueError(
            f"rows must be [B] int32, got {tuple(rows.shape)} {rows.dtype}"
        )
    if not 1 <= rows.shape[0] <= 2**32:
        raise ValueError(f"need 1 <= B <= 2^32 chains, got {rows.shape[0]}")
    if rows.device != table.device:
        raise ValueError(f"table on {table.device} but rows on {rows.device}")
    if not (table.is_contiguous() and rows.is_contiguous()):
        raise ValueError("table and rows must be contiguous")
    if row_base is None:
        return
    if row_base.dtype != torch.int32 or row_base.shape != rows.shape:
        raise ValueError(
            f"row_base must be [B={rows.shape[0]}] int32, got "
            f"{tuple(row_base.shape)} {row_base.dtype}"
        )
    if row_base.device != table.device:
        raise ValueError(
            f"table on {table.device} but row_base on {row_base.device}"
        )
    if not row_base.is_contiguous():
        raise ValueError("row_base must be contiguous")


def fused_chain_step_reference(
    seed: int, table: torch.Tensor, rows: torch.Tensor, num_qubits: int,
    step: int = 0, *, row_base: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the step kernel: the same gather, the same
    bits.

    ``table [G, N]`` float32, ``rows [B]`` int32 row ids (or, with
    ``row_base [B]`` int32, the chain state x: the row id is then
    ``row_base + x``), all row ids in ``[0, G)`` (raises otherwise), 64-bit
    ``seed``; returns ``[B]`` int32. Chain b draws the Philox4x32-10 block
    with counter (b, step, q // 4, 0) and key (seed mod 2^32, seed >> 32);
    bit q uses word q % 4 and ``u = (word >> 8) * 2^-24``.
    """
    _check_step_args(seed, table, rows, num_qubits, step, row_base)
    g = table.shape[0]
    ids = rows.long() if row_base is None else row_base.long() + rows.long()
    if int(ids.min()) < 0 or int(ids.max()) >= g:
        raise ValueError(f"row ids must lie in [0, {g})")
    n = num_qubits
    p1 = table[ids]  # [B, N]
    b_idx = torch.arange(rows.shape[0], device=rows.device, dtype=torch.int64)
    key = (seed & _MASK32, seed >> 32)
    x = torch.zeros_like(b_idx)
    zero = torch.zeros_like(b_idx)
    for qb in range((n + 3) // 4):
        words = philox4x32_10(
            (b_idx, torch.full_like(b_idx, step), torch.full_like(b_idx, qb),
             zero),
            key,
        )
        for k in range(min(4, n - 4 * qb)):
            q = 4 * qb + k
            u = (words[k] >> 8).to(torch.float32) * (1.0 / 16777216.0)
            x |= (u < p1[:, q]).to(torch.int64) << q
    return x.to(torch.int32)


@functools.cache
def _chain_step_fn():
    fn = _build.load("chain_step").ddqst_fused_chain_step
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,  # table, rows (or x)
        ctypes.c_void_p, ctypes.c_void_p,  # row_base (or null), out
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,  # G, N, B
        ctypes.c_uint,  # step
        ctypes.c_uint64,  # seed
        ctypes.c_void_p,  # stream
    ]
    return fn


def fused_chain_step(
    seed: int, table: torch.Tensor, rows: torch.Tensor, num_qubits: int,
    step: int = 0, *, row_base: torch.Tensor | None = None,
) -> torch.Tensor:
    """One reverse-sampler chain update in one CUDA kernel launch.

    Args:
      seed: 64-bit int; the Philox key.
      table: ``[G, N]`` float32 P(bit=1) per grid row, G < 2^31.
      rows: ``[B]`` int32 grid-row id per chain, in ``[0, G)`` (the kernel
        does not check: that would need a synchronisation). With
        ``row_base``, the chain state x instead.
      num_qubits: N, 1 <= N <= 30.
      step: the step's index, in ``[0, 2^32)``; the Philox counter's second
        word, so each step of one walk draws fresh bits under one seed.
      row_base: optional ``[B]`` int32 row offset per chain. The kernel then
        reads row ``row_base[b] + rows[b]``, so a walk passes its state
        straight from one step to the next and computes the offsets once.

    Returns:
      ``[B]`` int32 new outcome index per chain.

    CPU tensors take :func:`fused_chain_step_reference`; CUDA tensors launch
    the kernel on the current stream, or raise.
    """
    _check_step_args(seed, table, rows, num_qubits, step, row_base)
    if _on_cpu(table):
        return fused_chain_step_reference(seed, table, rows, num_qubits, step,
                                          row_base=row_base)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    out = torch.empty_like(rows)
    fn = _chain_step_fn()
    cur = torch.cuda.current_stream(table.device)
    timer = StepTimer.active
    if timer is not None:
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record(cur)
    with torch.cuda.device(table.device):
        err = fn(table.data_ptr(), rows.data_ptr(),
                 None if row_base is None else row_base.data_ptr(),
                 out.data_ptr(), table.shape[0], num_qubits, rows.shape[0],
                 step, seed, cur.cuda_stream)
    if err != 0:
        raise RuntimeError(f"chain_step kernel launch failed: cudaError {err}")
    fused_chain_step.launches += 1
    if timer is not None:
        pair[1].record(cur)
        timer.pairs.append(pair)
    return out


fused_chain_step.launches = 0


class StepTimer:
    """Within the block, each launch of :func:`fused_chain_step` records a
    CUDA event pair on its stream, one event just before the kernel and one
    just after; plain-version calls record nothing. The kernel's inputs,
    outputs and launch count are those of a run without the timer.
    ``ms()`` waits for the last event and returns each timed launch's
    milliseconds. Blocks do not nest."""

    active: "StepTimer | None" = None

    def __init__(self):
        self.pairs: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []

    def __enter__(self) -> "StepTimer":
        if StepTimer.active is not None:
            raise RuntimeError("a StepTimer is already active")
        StepTimer.active = self
        return self

    def __exit__(self, *exc) -> None:
        StepTimer.active = None

    def ms(self) -> list[float]:
        if self.pairs:
            self.pairs[-1][1].synchronize()
        return [a.elapsed_time(b) for a, b in self.pairs]

    def summary(self) -> dict:
        """``step_timed_launches``, ``step_ms_total`` (the sum of the
        launches' milliseconds) and ``step_ms_mean``; the times are
        ``None`` when no launch was timed."""
        ms = self.ms()
        total = sum(ms) if ms else None
        return dict(step_timed_launches=len(ms), step_ms_total=total,
                    step_ms_mean=total / len(ms) if ms else None)
