"""Three-term roofline of one step traced on ``meta`` tensors: the
counterpart of the JAX package's ``roofline/analysis.py``.

  compute term    = FLOPs / peak FLOP/s                 (per chip)
  memory term     = bytes / HBM bytes/s                 (per chip)
  collective term = wire bytes / link bytes/s           (per chip)

The reference reads XLA's compiled artifact: ``cost_analysis()`` for
FLOPs and bytes, and the collectives parsed from the HLO text.  The port
has no XLA, so ``traced_cost`` runs the step itself on ``meta`` tensors
(shapes only, nothing allocated) and counts what it does:

* FLOPs with ``torch.utils.flop_counter.FlopCounterMode``;
* bytes accessed as operand plus output bytes of every operation that
  is not a view: the same upper bound on HBM traffic that the
  reference's docstring admits for XLA:CPU's ``bytes accessed``;
* the peak of the bytes the step allocates and holds at once (storages
  it makes, less those freed; within 1% below the exact peak, see
  ``PEAK_SLACK``), which the dry run's memory record reads; the
  collector of reference cycles does not run during the trace, so what
  a cycle holds counts until the step ends;
* the B4 (RMSNorm) and B5 (SSD chunk) calls, through the kernels'
  ``TRACED`` counts (``kernels/{rmsnorm,ssd_chunk}/ops.py``);
* the collectives the mesh's per-shard bodies issued
  (``collective_stats``), from ``mesh.calls``
  (``distributed/collectives.py``).

Everything is per chip as the single-controller port computes it: work
on whole tensors (on the mesh's first device) and the per-coordinate
bodies together make the whole mesh's work, and the counts are divided by
the mesh's size; the reference's are per device of the SPMD program, its
loop bodies counted once.  A B4/B5 call on a whole tensor stands for one
launch on every chip's block, so those counts are not divided.

The times divide by a :class:`repro_torch.power.model.ChipTable`'s rates
(default the H100 SXM), where the reference reads its TPU constants.
XLA's HLO text (``shape_bytes``, the collective regular expressions,
``collective_bytes_from_hlo``) has no counterpart: the port never makes
it, and ``collective_stats`` reads the same quantities from the mesh.
"""
from __future__ import annotations

import copy
import gc
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.power.model import H100_SXM, ChipTable

# distributed.collectives' names, as XLA names the collective
XLA_KIND = {"all_gather": "all-gather", "psum": "all-reduce",
            "pmean": "all-reduce", "psum_scatter": "reduce-scatter"}
# the mesh axis whose collectives cross pods (the DCN term)
POD_AXIS = "pod"
# a new peak is taken only when the bytes held pass the last one by this
# factor, so the traced peak is at most 1% below the exact one; the dead
# storages are looked for only then (at every new high, a
# sequence-sharded train step's trace grew quadratic)
PEAK_SLACK = 1.01


@dataclass
class CollectiveStats:
    kind: str
    count: int = 0
    out_bytes: int = 0
    wire_bytes: float = 0.0          # per-chip, ring-model
    cross_pod: bool = False


def collective_stats(mesh, calls: Optional[Dict] = None,
                     ) -> Tuple[float, float, Dict[str, dict]]:
    """(ICI wire bytes, DCN wire bytes, per-kind stats) per chip, from
    ``calls`` (default ``mesh.calls``: every collective since the mesh was
    made): the reference's ``collective_bytes_from_hlo`` result.  A
    collective along the ``pod`` axis is keyed ``<kind>/dcn`` and charged
    to the DCN term; bytes are the sums over the mesh's coordinates over
    its size."""
    n = mesh.size()
    stats: Dict[str, CollectiveStats] = {}
    ici, dcn = 0.0, 0.0
    for (name, axis), rec in (mesh.calls if calls is None else calls).items():
        if not rec["count"]:
            continue
        cross = axis == POD_AXIS
        key = XLA_KIND[name] + ("/dcn" if cross else "")
        st = stats.setdefault(key, CollectiveStats(kind=key))
        wire = rec["wire_bytes"] / n
        st.count += rec["count"]
        st.out_bytes += rec["out_bytes"] // n
        st.wire_bytes += wire
        st.cross_pod = cross
        if cross:
            dcn += wire
        else:
            ici += wire
    return ici, dcn, {k: asdict(v) for k, v in stats.items()}


# ---------------------------------------------------------------------------

def model_flops(param_count: int, active_param_count: int, tokens: int,
                kind: str) -> float:
    """MODEL_FLOPS: 6·N·D train (fwd+bwd), 2·N·D forward-only."""
    n = active_param_count
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float                 # per chip (the port: traced)
    hlo_bytes: float                 # per chip (the port: traced)
    ici_bytes: float                 # per chip
    dcn_bytes: float                 # per chip
    model_flops_total: float
    useful_ratio: float              # MODEL_FLOPS / (FLOPs × chips)
    dominant: str = ""
    collectives: Dict[str, dict] = field(default_factory=dict)
    chip: ChipTable = field(default=H100_SXM, repr=False)

    def __post_init__(self):
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.dominant = max(terms, key=terms.get)

    @property
    def step_time_lower_bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs utilization if the step ran at its roofline bound."""
        t = self.step_time_lower_bound_s
        if t <= 0:
            return 0.0
        per_chip_useful = self.model_flops_total / max(
            1, self._chips) / t
        return per_chip_useful / self.chip.peak_bf16_flops

    _chips: int = 1


def analyze(flops_per_chip: float, bytes_per_chip: float,
            ici_bytes: float, dcn_bytes: float, chips: int,
            model_flops_total: float,
            collectives: Optional[Dict[str, dict]] = None, *,
            chip: ChipTable = H100_SXM) -> RooflineTerms:
    compute_s = flops_per_chip / chip.peak_bf16_flops
    memory_s = bytes_per_chip / chip.hbm_bw
    collective_s = ici_bytes / chip.link_bw + dcn_bytes / chip.dcn_bw
    useful = model_flops_total / max(flops_per_chip * chips, 1.0)
    t = RooflineTerms(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        hlo_flops=flops_per_chip, hlo_bytes=bytes_per_chip,
        ici_bytes=ici_bytes, dcn_bytes=dcn_bytes,
        model_flops_total=model_flops_total, useful_ratio=useful,
        collectives=collectives or {}, chip=chip)
    t._chips = chips
    return t


# ---------------------------------------------------------------------------
# Tracing a step on meta tensors
# ---------------------------------------------------------------------------

def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


_NO_KEY = object()       # an argument the op cache cannot key on
_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device,
            torch.layout, torch.memory_format)


def _scan(x, tensors: list):
    """``x``'s key for the op cache (``_NO_KEY`` where it has none), and
    its tensors appended to ``tensors``."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        keys = tuple(_scan(e, tensors) for e in x)
        return _NO_KEY if _NO_KEY in keys else (type(x),) + keys
    if isinstance(x, _SCALARS):
        return (type(x), x)          # 2 and 2.0 promote differently
    return _NO_KEY


class _Meter(TorchDispatchMode):
    """Operand plus output bytes of every operation that is not a view,
    the bytes of the storages the operations make while they live, and
    (through ``flop_mode``, below it) their FLOPs.

    ``meta`` computes an output's shape in Python for most functional
    operations (~0.2 ms each), and a step on a production mesh repeats
    the same operations on the same shapes (coordinates, layers, AdamW's
    blocks).  So the first call of a functional operation (not a view,
    not in place) on given shapes, strides and dtypes runs, and its
    outputs' shapes, strides and dtypes and its counted FLOPs are kept;
    a later call with the same key makes fresh outputs of that layout and
    adds those FLOPs, with the same counts as running it."""

    def __init__(self, flop_mode: FlopCounterMode):
        super().__init__()
        self.flop_mode = flop_mode
        self.cached_flops = 0
        self.bytes = 0
        self.live = 0           # bytes of ``made``: the live ones and more
        self.peak = 0
        # storage -> (a C++ weak reference to it, its bytes); the weak
        # reference keeps the address from being reused while it is held
        self.made: Dict[int, Tuple[int, int]] = {}
        self.cache: Dict[tuple, tuple] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins: list = []
        key = (func, _scan(args, ins), _scan(tuple(kwargs.items()), ins))
        if func.is_view or func._schema.is_mutable or _NO_KEY in key:
            key = None
        hit = self.cache.get(key) if key is not None else None
        if hit is not None:
            layouts, flops, kind = hit
            with torch._C._DisableTorchDispatch():   # not through the modes
                outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                            device="meta")
                        for shape, stride, dtype in layouts]
            out = outs[0] if kind is None else kind(outs)
            self.cached_flops += flops
        elif func.is_view:                  # no FLOPs, no bytes, no storage
            with torch._C._DisableTorchDispatch():
                return func(*args, **kwargs)
        else:
            f0 = self.flop_mode.get_total_flops()
            out = func(*args, **kwargs)
            flops = self.flop_mode.get_total_flops() - f0
            kind = None
            if isinstance(out, torch.Tensor):
                outs = [out]
            elif (isinstance(out, (list, tuple))
                  and all(isinstance(t, torch.Tensor) for t in out)):
                outs, kind = list(out), type(out)
            else:
                outs = [t for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor)]
                key = None
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        owned = {_storage_key(t) for t in ins}
        fresh = True
        for t in outs:
            k = _storage_key(t)
            if k in owned or k in self.made:
                fresh = False
                continue
            st = t.untyped_storage()
            n = st.nbytes()
            if n != _dense_bytes(t):
                fresh = False
            self.made[k] = (st._weak_ref(), n)
            self.live += n
            if self.live > self.peak * PEAK_SLACK:
                self._purge()
                self.peak = max(self.peak, self.live)
        if hit is None and key is not None and fresh and outs:
            self.cache[key] = (
                [(tuple(t.shape), t.stride(), t.dtype) for t in outs],
                flops, kind)
        return out

    def _drop(self, k: int) -> None:
        ref, n = self.made.pop(k)
        torch.UntypedStorage._free_weak_ref(ref)
        self.live -= n

    def _purge(self) -> None:
        """Drop every storage that has died, so that ``live`` is exact.
        Nothing tells of a storage's death as it happens (its Python
        object dies before it, and its last holder may be a tensor autograd
        saved, with none), so its C++ weak reference says."""
        for k, (ref, _) in list(self.made.items()):
            if torch.UntypedStorage._expired(ref):
                self._drop(k)

    def close(self) -> None:
        """Release every weak reference."""
        for k in list(self.made):
            self._drop(k)


def _dense_bytes(t: torch.Tensor) -> int:
    """The storage ``empty_strided`` makes for ``t``'s layout."""
    if t.numel() == 0:
        return 0
    span = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return (t.storage_offset() + span) * t.element_size()


def _kernel_counts() -> Dict[str, int]:
    from repro_torch.kernels.rmsnorm import kernel as rms
    from repro_torch.kernels.ssd_chunk import kernel as ssd
    return {**rms.TRACED, **ssd.TRACED}


@dataclass
class TracedCost:
    """One traced step, per chip (see the module's docstring).
    ``kernel_calls`` are the B4/B5 calls the step made; ``result`` is the
    step's return value on ``meta``, and ``made_bytes`` the bytes of its
    storages that the step allocated (not its arguments'), whole."""

    flops: float
    bytes: float
    peak_bytes: float
    ici_bytes: float
    dcn_bytes: float
    collectives: Dict[str, dict]
    kernel_calls: Dict[str, int]
    chips: int
    result: Any = field(default=None, repr=False)
    made_bytes: int = 0


def traced_cost(fn, *args, mesh=None) -> TracedCost:
    """Run ``fn(*args)`` (``meta`` tensors, or a mesh on ``meta``) and count
    its FLOPs, bytes, peak allocated bytes, B4/B5 calls and ``mesh``'s
    collectives, each per chip of ``mesh`` (one chip without)."""
    chips = mesh.size() if mesh is not None else 1
    calls0 = copy.deepcopy(mesh.calls) if mesh is not None else {}
    k0 = _kernel_counts()
    flop_mode = FlopCounterMode(display=False)
    meter = _Meter(flop_mode)
    # tensors held in reference cycles (frames kept by a traceback) live
    # until the collector runs, so the peak would depend on when it runs:
    # the trace runs without it, every cycle held to the end.  The modules
    # torch imports at its first use of a dispatch mode or a checkpoint
    # are imported first: an import inside the trace keeps its caller's
    # frames, and their tensors, in such a cycle
    import torch._dynamo  # noqa: F401
    collecting = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        with flop_mode, meter:
            result = fn(*args)
        made = sum(t.untyped_storage().nbytes()
                   for t in {_storage_key(t): t for t in tree_leaves(result)
                             if isinstance(t, torch.Tensor)}.values()
                   if _storage_key(t) in meter.made)
    finally:
        meter.close()
        if collecting:
            gc.enable()
    k1 = _kernel_counts()
    ici, dcn, stats = 0.0, 0.0, {}
    if mesh is not None:
        calls = {}
        for key, rec in mesh.calls.items():
            before = calls0.get(key, {})
            calls[key] = {k: v - before.get(k, 0) for k, v in rec.items()}
        ici, dcn, stats = collective_stats(mesh, calls)
    return TracedCost(
        flops=(flop_mode.get_total_flops() + meter.cached_flops) / chips,
        bytes=meter.bytes / chips, peak_bytes=meter.peak / chips,
        ici_bytes=ici, dcn_bytes=dcn, collectives=stats,
        kernel_calls={k: k1[k] - k0[k] for k in k1}, chips=chips,
        result=result, made_bytes=made)
