"""Room in the power sampler's pipe for a run on four cards.

``lib/power.py::PowerSamples`` starts ``nvidia-smi`` with its standard
output on a pipe and reads that pipe only when its ``with`` block ends.
A pipe holds 64 KiB on Linux unless asked for more.  nvidia-smi writes
~80 B a board every 100 ms, so four boards fill it ~21 s after the
sampler starts (one board in ~85 s); nvidia-smi then blocks on its next
write until the block ends, and a four-card run's window, which follows
~28 s of set-up, would hold no sample at all.

``widen`` asks the kernel for a larger pipe (``F_SETPIPE_SZ``) on the
read end this process holds of each running nvidia-smi's standard
output, 1 MiB where the system allows it: over 5 minutes of four boards'
samples.  It reads nothing from the pipe, so every line still reaches
``PowerSamples``, and it changes nothing for a run whose sampler never
filled its pipe.  A driver calls it first in its set-up, which the
harness runs inside the sampler's ``with`` block.
"""
from __future__ import annotations

import errno
import fcntl
import gc
import os
import subprocess

F_SETPIPE_SZ = getattr(fcntl, "F_SETPIPE_SZ", 1031)
DEFAULT = 1 << 16            # a pipe's capacity on Linux
WANTED = 1 << 20


def _program(args) -> str:
    first = args if isinstance(args, (str, bytes, os.PathLike)) else args[0]
    return os.path.basename(os.fsdecode(first).split()[0])


def widen(program: str = "nvidia-smi") -> list[int]:
    """Raise the capacity of the pipe that carries the standard output of
    each running child process of ``program`` to ``WANTED`` bytes, or to
    the largest power of two the system allows above the default; the
    capacities set, one for each such process."""
    got = []
    for obj in gc.get_objects():
        if not (issubclass(type(obj), subprocess.Popen)
                and obj.stdout is not None
                and obj.returncode is None and _program(obj.args) == program):
            continue
        fd, want = obj.stdout.fileno(), WANTED
        while want > DEFAULT:
            try:
                got.append(fcntl.fcntl(fd, F_SETPIPE_SZ, want))
                break
            except OSError as e:
                if e.errno != errno.EPERM:
                    raise
                want //= 2
    return got
