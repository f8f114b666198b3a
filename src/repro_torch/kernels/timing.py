"""Device time of the port's kernels, and the least time their work needs.

``timed_ms`` and ``queued_ms`` time calls by CUDA events, queued behind a
sleep kernel so that the host's launches (tens of microseconds per ctypes
launch) do not pace a kernel shorter than them; a reading the host paced
anyway is taken again behind a longer sleep.  A plain PyTorch version may
wait for the stream inside (a copy from pageable host memory does): its
reading is taken once, with the host's pace in it.  ``bound`` is the larger of
the bytes' time at the HBM rate and the operations' time at the peak rate
of their type (``roofline.hw``, the H100 SXM data sheet).  Both need a
CUDA device only when called.
"""
from __future__ import annotations

from repro_torch.roofline import hw

HOST_CYCLES_PER_CALL = 150_000  # sleep per queued call: ~75 us at 2 GHz
MIN_SLEEP_CYCLES = 50_000_000   # ~25 ms
RETRIES = 4


def queued_ms(calls, prepare=None, host_paced_ok: bool = False) -> float:
    """Mean device time of the calls (each a function of no arguments),
    queued behind a sleep kernel.  If the sleep had ended before the host
    had queued every call, the host paced the reading: unless
    ``host_paced_ok``, it is taken again, after ``prepare()``, behind a
    sleep four times as long."""
    import torch
    cycles = max(MIN_SLEEP_CYCLES, HOST_CYCLES_PER_CALL * len(calls))
    for _ in range(RETRIES):
        if prepare is not None:
            prepare()
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for call in calls:
            call()
        paced = start.query()
        end.record()
        torch.cuda.synchronize()
        if not paced or host_paced_ok:
            return start.elapsed_time(end) / len(calls)
        cycles *= 4
    raise RuntimeError("the host paced every reading of these calls")


def timed_ms(fn, reps: int, warmup: int,
             host_paced_ok: bool = False) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    return queued_ms([fn] * reps, host_paced_ok=host_paced_ok)


def bound(in_out, sites: int, flops_per_site: int,
          bf16_tc_flops: int = 0) -> tuple[float, str]:
    """Least time (ms) for the work: each of ``in_out`` (the inputs and the
    outputs, tensors) read or written once at the HBM rate, or the flops
    at the f32 rate plus ``bf16_tc_flops`` (bf16 operands, f32 sums) at
    the bf16 tensor-core rate; and which of the two it is."""
    nbytes = sum(t.numel() * t.element_size() for t in in_out)
    t_bytes = nbytes / hw.HBM_BW * 1e3
    t_ops = (sites * flops_per_site / hw.PEAK_F32_FLOPS
             + bf16_tc_flops / hw.PEAK_BF16_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
