"""Program spans on the profiler's clock.

``span(name)`` marks a stretch of the host's work while a
``torch.profiler`` records: it opens a function-scope record that the
profiler keeps in the same event list as the device's activities, on the
same clock, and the span open around it is its parent.  With no profiler
recording it returns one shared no-op, so an unprofiled run pays a check
of the profiler's state per span and nothing else; there is no flag.

A function-scope record (``RecordScope::FUNCTION``, as an aten op's) and
not ``torch.profiler.record_function``'s user scope: for a user-scope
range kineto adds a device-typed ``gpu_user_annotation`` range from its
first launch to its last, which a reader that takes every device-typed
event for device activity counts as busy, idle gaps included.

``host_sync(t, name)`` reads a 0-dim tensor back to the host inside a
``*.host_sync`` span, by ``t.item()`` as ``float(t)`` and ``bool(t)``
do.  Every device-to-host read of the LQCD solve and of HPL is in such a
span (HPL's one read, of the pivots, is a list), so the count of those
spans is the path's count of host syncs; with no profiler recording a
``host_sync`` is the read and one check.

The names are fixed; each is a constant below.
"""
from __future__ import annotations

import contextlib

import torch

# LQCD (lqcd/cg.py)
LQCD_SOLVE = "lqcd.solve"                # solve_dirac, one per call
LQCD_EO_PREPARE = "lqcd.eo.prepare"      # gauge packed and rounded, rhs_e, |b|
LQCD_EO_OUTER = "lqcd.eo.outer"          # one per defect-correction round
LQCD_CG_ITER = "lqcd.cg.iter"            # one per cg_solve iteration
LQCD_NORMAL_OP = "lqcd.normal_op"        # the matvec inside an iteration
LQCD_HOST_SYNC = "lqcd.host_sync"        # each read-back to the host
LQCD_EO_FINISH = "lqcd.eo.finish"        # odd reconstruction, true residual
# LQCD on T-slabs over several devices (lqcd/multichip_eo.py, multichip.py)
LQCD_HALO = "lqcd.halo"                  # a sharded hop's halo exchange
LQCD_REDUCE = "lqcd.reduce"              # the shards' partial dots summed
# HPL (hpl/lu.py)
HPL_LU = "hpl.lu"                        # blocked_lu
HPL_PANEL = "hpl.panel"                  # each panel and its swaps
HPL_TRSM = "hpl.trsm"                    # the U12 solve
HPL_UPDATE = "hpl.update"                # the trailing update, lookahead 0
HPL_UPDATE_NEXT = "hpl.update.next"      # the next panel's columns
HPL_UPDATE_REST = "hpl.update.rest"      # the rest of the trailing matrix
HPL_SOLVE = "hpl.solve"                  # lu_solve
HPL_SOLVE_PERM = "hpl.solve.perm"        # the pivots read, the permutation
HPL_SOLVE_TRSV = "hpl.solve.trsv"        # the two triangular solves
HPL_HOST_SYNC = "hpl.host_sync"          # the pivots read back

NAMES = (LQCD_SOLVE, LQCD_EO_PREPARE, LQCD_EO_OUTER, LQCD_CG_ITER,
         LQCD_NORMAL_OP, LQCD_HOST_SYNC, LQCD_EO_FINISH, LQCD_HALO,
         LQCD_REDUCE,
         HPL_LU, HPL_PANEL, HPL_TRSM, HPL_UPDATE, HPL_UPDATE_NEXT,
         HPL_UPDATE_REST, HPL_SOLVE, HPL_SOLVE_PERM, HPL_SOLVE_TRSV,
         HPL_HOST_SYNC)

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled
_record = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context manager: the span ``name`` while a profiler records,
    the shared no-op otherwise."""
    if not _recording():
        return _OFF
    return _record(name)


def host_sync(t: torch.Tensor, name: str):
    """The 0-dim ``t`` read back to the host as a Python scalar
    (``t.item()``) inside the span ``name``."""
    if not _recording():
        return t.item()
    with _record(name):
        return t.item()
