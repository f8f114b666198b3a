"""Multi-device even-odd D-slash and CG: the compact checkerboarded
half-lattices T-sharded over a :class:`~repro_torch.distributed.LatticeMesh`
— the port of the JAX package's ``lqcd/multichip_eo.py``.

This is the paper's production configuration, multi-GPU LQCD chosen for
memory bandwidth, applied to the even-odd solver of
:mod:`repro_torch.lqcd.eo`:

  * Each T-shard owns a ``(X/2, Y, Z, T/n)`` block of both parity
    half-fields, as a tensor on its shard's device.  x/y/z hops never
    cross a shard boundary; only the ±t hops read the neighbours' slices.
  * Per half-hop, two halo messages cross between neighbours: the two
    *spin-projected* components the Wilson projector keeps (``(1 ∓ γ_t)``
    is ``diag(0,0,2,2)`` / ``diag(2,2,0,0)`` in the Dirac basis), half a
    spinor slice each way, and no gauge traffic: the neighbours' link
    slices are loop-invariant and cross once per gauge field.
  * On the card each shard's hop is the hand-written even-odd kernel (B1,
    ``dslash_eo_kernel``) on a halo-padded block (``_half_hop_padded``);
    on the CPU it is the plain ``_half_hop_local``.

:func:`solve_wilson_eo_slabs` is the whole EO_MIXED solve on a field
held as T-slabs, slab ``j`` on ``mesh.devices[j]``, from entry to return:
each shard packs its own gauge halves and their rounded copy, and only
the halos and the gauge's boundary slices cross between shards.  Every
vector of the solve (right-hand side, CG vectors, defect, answer) stays
as per-shard blocks; each reduction is the sum of the shards' partial
dot products (an ``lqcd.reduce`` span), each halo exchange an
``lqcd.halo`` span, and the solver's spans and host syncs are those of
the one-device solve.  The whole-tensor ``mesh=`` solve
(:func:`solve_wilson_eo_whole`) cuts its inputs into slabs, runs it, and
gathers ``x``.

Differences from the JAX module, by design:

  * **Dispatch by device**, not by a backend name: ``backend=None`` runs
    the padded kernel path on a CUDA mesh and the plain hop on a CPU mesh.
    ``backend="kernel"`` on a CPU mesh runs the padded path through the
    plain EO hop (``dslash_eo_split_ref``), so the CPU tests reach the
    padding.  No plain hop runs on the card.
  * **One process drives every shard**, as one JAX controller drives its
    ``shard_map``; there is no ``torch.distributed``.  Nothing overlaps
    in an eager single process, so the plain hop has one formulation
    (spin-projected halos, zero-filled onto the block's ends) where the
    JAX module has two (``overlap``), which compute the same sums.
  * **No ``t_block``**: B1 has no T blocking to tune, so the JAX module's
    ``sharded_t_block`` lookup has no counterpart.
  * **The odd reconstruction and the true residual run sharded**; the JAX
    function hands its still-sharded ``x_e`` to the one-device
    reconstruction, which fails there.
  * :func:`measured_lqcd_calibration`'s ``n_devices`` counts the distinct
    devices the shards sit on, not the shard count.

``measured_lqcd_calibration`` closes the loop with the cluster layer: it
times the executed Schur normal op A†A (one device, or the sharded one),
puts the run on the telemetry bus, and returns an :class:`LQCDCalibration`
that ``repro_torch.cluster.workload.LQCDSolveWorkload`` consumes in place
of the analytic S9150 roofline.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.lcsc_lqcd import (DSLASH_BW_FRACTION,
                                           MULTI_GPU_SLOWDOWN, S9150_BW_GBS)
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (LatticeMesh, gather_t_blocks,
                                              lattice_eo_specs,
                                              split_t_blocks)
from repro_torch.kernels.dslash.kernel import dslash_eo_split
from repro_torch.kernels.dslash.ref import (dslash_eo_split_ref, from_split,
                                            to_split)
from repro_torch.lqcd.cg import (CGResult, EOCGResult, _dot, _read,
                                 _round_complex)
from repro_torch.lqcd.dirac import (dslash_bytes_per_site,
                                    dslash_flops_per_site, gamma5, mv, mv_dag,
                                    spin)
from repro_torch.lqcd.eo import (PROJ_M, PROJ_P, _s_out, eo_pack, eo_unpack,
                                 hops_spatial, pack_gauge, schur_matvec,
                                 schur_matvec_dagger)
from repro_torch.lqcd.multichip import (T_AX, dslash_slabs, halo_perms,
                                        ppermute, scatter_spin, send_halos)
from repro_torch.lqcd.su3 import random_field_and_source
from repro_torch.power.model import (H100_SXM, OperatingPoint,
                                     gpu_power_throttled, h100_chip_power)
from repro_torch.power.trace import TraceRecorder
from repro_torch.spans import (LQCD_CG_ITER, LQCD_EO_FINISH, LQCD_EO_OUTER,
                               LQCD_EO_PREPARE, LQCD_HALO, LQCD_NORMAL_OP,
                               LQCD_REDUCE, span)

__all__ = [
    "LQCDCalibration",
    "ShardedWilsonEO",
    "analytic_lqcd_calibration",
    "dslash_half_sharded",
    "measured_lqcd_calibration",
    "solve_wilson_eo_slabs",
    "solve_wilson_eo_whole",
]

_G_AX, _P_AX = lattice_eo_specs()


def _check_mesh(mesh) -> None:
    if not isinstance(mesh, LatticeMesh):
        raise TypeError(f"mesh must be a LatticeMesh "
                        f"(repro_torch.distributed.lattice_mesh), got "
                        f"{type(mesh).__name__}")


def _check_slabs(name: str, slabs: Sequence[torch.Tensor], mesh: LatticeMesh,
                 t_axis: int) -> None:
    """One T-slab a shard, each on its shard's device, all of one T extent."""
    if len(slabs) != mesh.n:
        raise ValueError(f"{name} has {len(slabs)} T-slabs for a "
                         f"{mesh.n}-shard mesh")
    for j, (s, d) in enumerate(zip(slabs, mesh.devices)):
        if s.device != d:
            raise ValueError(f"{name}[{j}] is on {s.device}, its shard on {d}")
        if s.shape[t_axis] != slabs[0].shape[t_axis]:
            raise ValueError(f"{name}'s T-slabs differ in T extent")


def _parity_at(parity: int, t0: int) -> int:
    """The local parity, in a T-slab whose first row is global ``t0``, of
    the sites of global ``parity``."""
    return (parity + t0) % 2


# ---------------------------------------------------------------------------
# Loop-invariant preparation, once per gauge field
# ---------------------------------------------------------------------------

def _pack_gauge_slab(U: torch.Tensor, t0: int) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """The global even and odd gauge halves of a T-slab whose first row is
    global ``t0``, packed on the slab's device."""
    halves = pack_gauge(U)
    return halves if _parity_at(0, t0) == 0 else halves[::-1]


def _prev_t_links(hs: Sequence[torch.Tensor]) -> List:
    """Per shard, the *previous* shard's last +t link slice.

    The -t hop at a shard's first T-row needs the source-parity gauge link
    at global ``t = j*T_local - 1``.  The gauge field is constant across a
    solve, so each shard gets its copy, shape ``(Xh, Y, Z, 1, 3, 3)``,
    once; no link crosses between shards per hop.
    """
    tl = hs[0].shape[_G_AX]
    last = [h[3].narrow(T_AX, tl - 1, 1) for h in hs]
    return [u.contiguous() for u in ppermute(last, halo_perms(len(hs))[1])]


def _padded_gauge(hs: Sequence[torch.Tensor]) -> List:
    """Per shard, its gauge half on a halo-padded block: its local T
    extent grows to ``T_local + 2`` with the neighbours' boundary slices
    (which cross once) baked in (shape ``(4, Xh, Y, Z, T_local + 2, 3,
    3)``, contiguous)."""
    fwd, bwd = halo_perms(len(hs))
    tl = hs[0].shape[_G_AX]
    nxt = ppermute([h.narrow(_G_AX, 0, 1) for h in hs], fwd)
    prv = ppermute([h.narrow(_G_AX, tl - 1, 1) for h in hs], bwd)
    return [torch.cat([p, h, q], _G_AX) for h, p, q in zip(hs, prv, nxt)]


# ---------------------------------------------------------------------------
# Local (per-shard) hop bodies
# ---------------------------------------------------------------------------

def _half_hop_local(U_out: torch.Tensor, U_src: torch.Tensor,
                    u_prev: torch.Tensor, psi: torch.Tensor,
                    from_next: torch.Tensor, from_prev: torch.Tensor, *,
                    out_parity: int, t0: int) -> torch.Tensor:
    """One parity block of D-slash on a T-shard (compact layout), plain
    version.

    ``u_prev`` is the previous shard's last +t link slice of the *source*
    parity, shape ``(Xh, Y, Z, 1, 3, 3)``; ``t0`` is the shard's first
    global t.  The halos are the spin-projected halves, zero-filled onto
    the block's two ends: the t projectors annihilate the fill exactly.
    """
    Xh, Y, Z, Tl = psi.shape[:4]
    # the parity offset pattern s = (y+z+t+parity) % 2 depends on *global*
    # t: shift the local pattern by this shard's T offset (shards with odd
    # T_local alternate patterns, e.g. 8^4 over 8 shards)
    s_out = _s_out((2 * Xh, Y, Z, Tl), _parity_at(out_parity, t0),
                   psi.device)
    out = hops_spatial(U_out, U_src, psi, s_out)
    psi_f = torch.cat([psi.narrow(T_AX, 1, Tl - 1),
                       scatter_spin(from_next, 2)], T_AX)
    out = out + spin(PROJ_M[3], mv(U_out[3], psi_f))
    psi_b = torch.cat([scatter_spin(from_prev, 0),
                       psi.narrow(T_AX, 0, Tl - 1)], T_AX)
    u_b = torch.cat([u_prev, U_src[3].narrow(T_AX, 0, Tl - 1)], T_AX)
    return out + spin(PROJ_P[3], mv_dag(u_b, psi_b))


def _half_hop_padded(U_out_pad: torch.Tensor, U_src_pad: torch.Tensor,
                     psi_pad: torch.Tensor, src_parity_eff: int
                     ) -> torch.Tensor:
    """Per-shard hop through the EO hop on halo-padded fields: B1 on a
    CUDA tensor, its plain version (``dslash_eo_split_ref``) on a CPU one.

    ``psi_pad`` holds the spin-projected halos zero-filled into pad rows 0
    and ``T_local + 1`` — exact, since the t projectors annihilate the
    fill (B1's t hop reads only spin components 2-3 forward and 0-1
    backward).  The hop's periodic wrap in T lands only on the pad rows,
    which are cropped.  ``src_parity_eff`` absorbs the pad's t-shift of 1:
    with an even ``T_local`` every shard sees the same parity pattern, and
    every real row reads the operands of the one-device hop in the same
    order.  B1 has no T blocking, so there is no ``t_block`` to choose per
    padded volume.
    """
    hop = (dslash_eo_split_ref if psi_pad.device.type == "cpu"
           else dslash_eo_split)
    out_pad = from_split(hop(to_split(U_out_pad), to_split(U_src_pad),
                             to_split(psi_pad), src_parity_eff))
    return out_pad.narrow(T_AX, 1, psi_pad.shape[T_AX] - 2)


# ---------------------------------------------------------------------------
# The gauge-bound sharded operator set
# ---------------------------------------------------------------------------

class ShardedWilsonEO:
    """T-sharded even-odd Wilson operator set, bound to one gauge field.

    ``U_e``/``U_o`` are the packed gauge halves: global tensors, split
    over the mesh here, or sequences of per-shard T-blocks, block ``j`` on
    ``mesh.devices[j]`` (:meth:`from_slabs` packs them from gauge slabs on
    each shard's device).  Construction bakes in what each hop needs: the
    previous shard's +t link slices (plain hop) or the halo-padded gauge
    blocks (kernel hop), the only gauge slices that cross between shards.
    The public methods take and return *global* compact tensors (results
    on the input's device); the solve works on per-shard blocks (lists,
    one tensor a shard).  ``backend`` is ``None`` (the kernel on a CUDA
    mesh, the plain hop on a CPU mesh) or ``"kernel"`` (the padded path on
    either; module docstring).
    """

    def __init__(self, U_e, U_o, kappa: float, mesh: LatticeMesh, *,
                 backend: Optional[str] = None):
        if backend not in (None, "kernel"):
            raise ValueError(f"unknown backend {backend!r}")
        _check_mesh(mesh)
        self.mesh = mesh
        self.kappa = float(kappa)
        self.n = mesh.n
        if isinstance(U_e, torch.Tensor):
            T = int(U_e.shape[_G_AX])
            if T % self.n:
                raise ValueError(f"lattice T extent {T} is not divisible by "
                                 f"the {self.n}-shard mesh")
            U_e = split_t_blocks(U_e, mesh, _G_AX)
            U_o = split_t_blocks(U_o, mesh, _G_AX)
        else:
            _check_slabs("U_e", U_e, mesh, _G_AX)
            _check_slabs("U_o", U_o, mesh, _G_AX)
        self.t_local = int(U_e[0].shape[_G_AX])
        if backend is None:
            on_card = mesh.devices[0].type != "cpu"
            backend = "kernel" if on_card else "plain"
        self.backend = backend
        if backend == "kernel":
            if self.t_local % 2:
                raise ValueError(
                    "backend='kernel' needs an even local T extent (the halo "
                    f"pad shifts parity per shard); got T_local="
                    f"{self.t_local}")
            self._gauge = (_padded_gauge(U_e), _padded_gauge(U_o))
        else:
            self._gauge = (list(U_e), list(U_o), _prev_t_links(U_e),
                           _prev_t_links(U_o))

    @classmethod
    def from_slabs(cls, U: Sequence[torch.Tensor], kappa: float,
                   mesh: LatticeMesh, *, backend: Optional[str] = None
                   ) -> "ShardedWilsonEO":
        """The operator set of a gauge field held as T-slabs ``(4, X, Y, Z,
        T_local, 3, 3)``, slab ``j`` on ``mesh.devices[j]``: each shard
        packs its own halves."""
        _check_mesh(mesh)
        _check_slabs("U", U, mesh, _G_AX)
        tl = int(U[0].shape[_G_AX])
        halves = [_pack_gauge_slab(u, j * tl) for j, u in enumerate(U)]
        return cls([h[0] for h in halves], [h[1] for h in halves], kappa,
                   mesh, backend=backend)

    def rounded(self, dtype) -> "ShardedWilsonEO":
        """The same operator on its gauge blocks rounded through ``dtype``
        (``cg._round_complex``), each on its shard's device."""
        lo = copy.copy(self)
        lo._gauge = tuple([_round_complex(g, dtype) for g in gs]
                          for gs in self._gauge)
        return lo

    # -- per-shard blocks ---------------------------------------------------

    def _split(self, v: torch.Tensor) -> List[torch.Tensor]:
        return split_t_blocks(v, self.mesh, _P_AX)

    def _gather(self, vs: Sequence[torch.Tensor], like: torch.Tensor):
        return gather_t_blocks(vs, _P_AX, like.device)

    def _hop(self, vs: Sequence[torch.Tensor], src_parity: int) -> List:
        """One sharded EO hop: ``vs`` on ``src_parity`` sites, per shard."""
        if self.backend == "kernel":
            U_e, U_o = self._gauge
            u_out, u_src = (U_o, U_e) if src_parity == 0 else (U_e, U_o)
            with span(LQCD_HALO):
                from_next, from_prev = send_halos(vs, projected=True)
                pads = [torch.cat([scatter_spin(p, 0), v,
                                   scatter_spin(q, 2)], T_AX)
                        for v, q, p in zip(vs, from_next, from_prev)]
            return [_half_hop_padded(u_out[j], u_src[j], pads[j],
                                     1 - src_parity) for j in range(self.n)]
        U_e, U_o, up_e, up_o = self._gauge
        u_out, u_src, u_prev = ((U_o, U_e, up_e) if src_parity == 0
                                else (U_e, U_o, up_o))
        with span(LQCD_HALO):
            from_next, from_prev = send_halos(vs, projected=True)
        return [_half_hop_local(
            u_out[j], u_src[j], u_prev[j], vs[j], from_next[j], from_prev[j],
            out_parity=1 - src_parity, t0=j * self.t_local)
            for j in range(self.n)]

    def _schur(self, vs: Sequence[torch.Tensor]) -> List:
        d = self._hop(self._hop(vs, 0), 1)   # even -> odd -> even
        k2 = self.kappa * self.kappa
        return [v - k2 * di for v, di in zip(vs, d)]

    def _schur_dagger(self, vs: Sequence[torch.Tensor]) -> List:
        return [gamma5(w) for w in self._schur([gamma5(v) for v in vs])]

    def _rhs(self, b_e: Sequence[torch.Tensor],
             b_o: Sequence[torch.Tensor]) -> List:
        return [e + self.kappa * d for e, d in zip(b_e, self._hop(b_o, 1))]

    def _reconstruct(self, x_e: Sequence[torch.Tensor],
                     b_o: Sequence[torch.Tensor]) -> List:
        return [o + self.kappa * d for o, d in zip(b_o, self._hop(x_e, 0))]

    def reduce(self, a: Sequence[torch.Tensor],
               c: Sequence[torch.Tensor]) -> torch.Tensor:
        """Re <a, c> of two per-shard fields: the shards' partial dot
        products summed in shard order on shard 0's device (an
        ``lqcd.reduce`` span)."""
        dev0 = self.mesh.devices[0]
        with span(LQCD_REDUCE):
            parts = [_dot(ai, ci) for ai, ci in zip(a, c)]
            total = parts[0]
            for p in parts[1:]:
                total = total + p.to(dev0)
        return total

    def _bcast(self, s: torch.Tensor) -> List[torch.Tensor]:
        """A 0-dim tensor on shard 0's device, on every shard's device."""
        return [s.to(d) for d in self.mesh.devices]

    # -- public operators (global compact tensors) --------------------------

    def dslash_half(self, psi: torch.Tensor, src_parity: int) -> torch.Tensor:
        """Sharded equivalent of :func:`repro_torch.lqcd.eo.dslash_half`
        (with the gauge halves bound at construction)."""
        return self._gather(self._hop(self._split(psi), src_parity), psi)

    def schur(self, psi_e: torch.Tensor) -> torch.Tensor:
        return self._gather(self._schur(self._split(psi_e)), psi_e)

    def schur_dagger(self, psi_e: torch.Tensor) -> torch.Tensor:
        return self._gather(self._schur_dagger(self._split(psi_e)), psi_e)

    def normal(self, psi_e: torch.Tensor) -> torch.Tensor:
        """A†A in one sharded call (the calibration's unit)."""
        return self._gather(
            self._schur_dagger(self._schur(self._split(psi_e))), psi_e)

    def rhs(self, b_e: torch.Tensor, b_o: torch.Tensor) -> torch.Tensor:
        """Even-system right-hand side b'_e = b_e + κ D_eo b_o."""
        return self._gather(self._rhs(self._split(b_e), self._split(b_o)),
                            b_e)

    def reconstruct(self, x_e: torch.Tensor,
                    b_o: torch.Tensor) -> torch.Tensor:
        """Back-substitute the odd sites: x_o = b_o + κ D_oe x_e."""
        return self._gather(
            self._reconstruct(self._split(x_e), self._split(b_o)), x_e)

    # -- the inner CG on per-shard blocks -----------------------------------

    def cg_normal(self, b: torch.Tensor, *, tol: float, max_iters: int,
                  inner_dtype=None) -> CGResult:
        """:meth:`cg_blocks` on a global compact ``b``: split once, ``x``
        gathered once."""
        res = self.cg_blocks(self._split(b), tol=tol, max_iters=max_iters,
                             inner_dtype=inner_dtype)
        return res._replace(x=self._gather(res.x, b))

    def cg_blocks(self, b: Sequence[torch.Tensor], *, tol: float,
                  max_iters: int, inner_dtype=None) -> CGResult:
        """CGNE on A†A with every vector kept as per-shard blocks; ``x``
        comes back as blocks.  Each reduction is :meth:`reduce`.
        ``inner_dtype`` rounds fields exactly like the one-device
        ``normal_lo`` of :func:`repro_torch.lqcd.cg.solve_wilson_eo`.  The
        stopping test is read back every iteration, and the spans are
        those of :func:`repro_torch.lqcd.cg.cg_solve`, which keeps the
        iteration counts equal to the one-device solve's and the JAX
        ``while_loop``'s.
        """

        def normal(vs):
            if inner_dtype is None:
                return self._schur_dagger(self._schur(vs))
            vs = [_round_complex(v, inner_dtype) for v in vs]
            av = [_round_complex(a, inner_dtype) for a in self._schur(vs)]
            return [_round_complex(w, inner_dtype)
                    for w in self._schur_dagger(av)]

        r = list(b)
        rs = self.reduce(r, r)
        b_norm = torch.sqrt(rs)
        x = [torch.zeros_like(v) for v in r]
        p = r
        it = 0

        def more():
            return it < max_iters and _read(torch.sqrt(rs) > tol * b_norm)

        go = more()
        while go:
            with span(LQCD_CG_ITER):
                with span(LQCD_NORMAL_OP):
                    ap = normal(p)
                alpha = self._bcast(
                    rs / torch.clamp(self.reduce(p, ap), min=1e-30))
                x = [xi + a * pi for xi, a, pi in zip(x, alpha, p)]
                r = [ri - a * api for ri, a, api in zip(r, alpha, ap)]
                rs_new = self.reduce(r, r)
                beta = self._bcast(rs_new / torch.clamp(rs, min=1e-30))
                p = [ri + bt * pi for ri, bt, pi in zip(r, beta, p)]
                rs = rs_new
                it += 1
                go = more()
        rel = _read(torch.sqrt(rs) / torch.clamp(b_norm, min=1e-30))
        return CGResult(x, it, rel, rel <= tol)


def dslash_half_sharded(U_e: torch.Tensor, U_o: torch.Tensor,
                        psi: torch.Tensor, src_parity: int,
                        mesh: LatticeMesh, *,
                        backend: Optional[str] = None) -> torch.Tensor:
    """One-shot sharded EO hop on global compact tensors (test and bench
    entry point; for repeated application build a :class:`ShardedWilsonEO`)."""
    ops = ShardedWilsonEO(U_e, U_o, 0.0, mesh, backend=backend)
    return ops.dslash_half(psi, src_parity)


# ---------------------------------------------------------------------------
# The solve on T-slabs
# ---------------------------------------------------------------------------

def solve_wilson_eo_slabs(U: Sequence[torch.Tensor],
                          b: Sequence[torch.Tensor], kappa: float,
                          mesh: LatticeMesh, *, tol: float = 1e-6,
                          max_iters: int = 1000, inner_dtype=None,
                          inner_tol: float = 1e-2, max_outer: int = 30,
                          backend: Optional[str] = None) -> EOCGResult:
    """:func:`repro_torch.lqcd.cg.solve_wilson_eo` on a field held as
    T-slabs, from entry to return.

    ``U`` holds one gauge slab ``(4, X, Y, Z, T/n, 3, 3)`` and ``b`` one
    source slab ``(X, Y, Z, T/n, 4, 3)`` a shard, slab ``j`` on
    ``mesh.devices[j]``; the result's ``x`` is the answer's slabs, on the
    same devices.  The algorithm, its rounding, its stopping tests, spans
    and host syncs are the one-device solve's; no tensor of the whole
    lattice is made on any device.  ``backend`` is
    :class:`ShardedWilsonEO`'s.
    """
    _check_mesh(mesh)
    _check_slabs("b", b, mesh, T_AX)
    t0s = [j * int(b[0].shape[T_AX]) for j in range(mesh.n)]
    with span(LQCD_EO_PREPARE):
        hi = ShardedWilsonEO.from_slabs(U, kappa, mesh, backend=backend)
        lo = hi if inner_dtype is None else hi.rounded(inner_dtype)
        b_e = [eo_pack(v, _parity_at(0, t0)) for v, t0 in zip(b, t0s)]
        b_o = [eo_pack(v, _parity_at(1, t0)) for v, t0 in zip(b, t0s)]
        b_norm = _read(torch.sqrt(hi.reduce(b, b)))
        # no low-precision pass gets below its own roundoff; full precision
        # drives straight to tol in one outer sweep
        eta = inner_tol if inner_dtype is not None else tol
        rhs_e = hi._rhs(b_e, b_o)

    x_e = [torch.zeros_like(v) for v in rhs_e]
    r_s = rhs_e                              # Schur-system residual
    total_inner = 0
    outer = 0
    while outer < max_outer and total_inner < max_iters:
        rel = _read(torch.sqrt(hi.reduce(r_s, r_s))) / max(b_norm, 1e-30)
        if rel <= tol:
            break
        with span(LQCD_EO_OUTER):
            # inner CG on the defect equation A†A e = A† r_s, reduced
            # precision, each low-precision restart capped as on one device
            remaining = max_iters - total_inner
            round_cap = (remaining if inner_dtype is None
                         else min(remaining, max(10, max_iters // 5)))
            inner = lo.cg_blocks(hi._schur_dagger(r_s), tol=eta,
                                 max_iters=round_cap, inner_dtype=inner_dtype)
            total_inner += inner.iters
            x_e = [x + e for x, e in zip(x_e, inner.x)]
            r_s = [r - a for r, a in zip(rhs_e, hi._schur(x_e))]
            outer += 1

    with span(LQCD_EO_FINISH):
        x_o = hi._reconstruct(x_e, b_o)
        x = [eo_unpack(e, o) if _parity_at(0, t0) == 0 else eo_unpack(o, e)
             for e, o, t0 in zip(x_e, x_o, t0s)]
        d = dslash_slabs(U, x)
        true_r = [bj - (xj - kappa * dj) for bj, xj, dj in zip(b, x, d)]
        rel = _read(torch.sqrt(hi.reduce(true_r, true_r))) / max(b_norm,
                                                                 1e-30)
    return EOCGResult(x, total_inner, outer, rel, rel <= tol)


def solve_wilson_eo_whole(U: torch.Tensor, b: torch.Tensor, kappa: float,
                          mesh: LatticeMesh, **kw) -> EOCGResult:
    """:func:`solve_wilson_eo_slabs` on whole tensors: ``U`` and ``b`` cut
    into the mesh's T-slabs at its start, ``x`` gathered on ``b``'s device
    at its end (the whole-tensor ``mesh=`` solve)."""
    _check_mesh(mesh)
    res = solve_wilson_eo_slabs(split_t_blocks(U, mesh, T_AX + 1),
                                split_t_blocks(b, mesh, T_AX), kappa, mesh,
                                **kw)
    return res._replace(x=gather_t_blocks(res.x, T_AX, b.device))


# ---------------------------------------------------------------------------
# Measured calibration — executed GFLOP/s and watts on the telemetry bus
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LQCDCalibration:
    """LQCD operating figures for the cluster layer.

    ``source="measured"`` entries come from timing the executed normal op
    (:func:`measured_lqcd_calibration`); ``source="analytic"`` restates
    the S9150 roofline (:func:`analytic_lqcd_calibration`) in the same
    shape so :class:`~repro_torch.cluster.workload.LQCDSolveWorkload` can
    consume either and report the delta.
    """

    lattice: Tuple[int, int, int, int]
    n_devices: int
    gflops: float                # sustained over the timed normal ops
    eff_bw_gbs: float            # executed aggregate streaming bandwidth
    busy_w: float                # aggregate device power while busy
    wall_s: float
    energy_j: float              # integrated from the telemetry bus
    source: str = "measured"
    trace: Optional[Any] = field(default=None, repr=False, compare=False)

    @property
    def gflops_per_w(self) -> float:
        return self.gflops / max(self.busy_w, 1e-9)


def _busy_watts(op=None, n_devices: int = 1) -> float:
    """S9150 board watts at ``op`` (the Green500 point by default)."""
    op = op or OperatingPoint.green500()
    return n_devices * gpu_power_throttled(op.f_mhz, op.vid,
                                           temp_c=op.temperature(), util=1.0)


def analytic_lqcd_calibration(lattice: Tuple[int, int, int, int],
                              n_devices: int = 1, op=None,
                              ) -> LQCDCalibration:
    """The S9150 roofline restated as a calibration (fallback path)."""
    volume = int(np.prod(lattice))
    slowdown = 1.0 - (MULTI_GPU_SLOWDOWN if n_devices > 1 else 0.0)
    eff_bw = S9150_BW_GBS * DSLASH_BW_FRACTION * n_devices * slowdown
    bytes_op = 2 * volume * dslash_bytes_per_site(4)
    flops_op = 2 * volume * dslash_flops_per_site()
    wall = bytes_op / (eff_bw * 1e9)
    busy_w = _busy_watts(op, n_devices)
    return LQCDCalibration(tuple(lattice), n_devices, flops_op / wall / 1e9,
                           eff_bw, busy_w, wall, busy_w * wall,
                           source="analytic")


def _synchronize(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def measured_lqcd_calibration(lattice: Tuple[int, int, int, int]
                              = (8, 8, 8, 16), *, kappa: float = 0.12,
                              mesh: Optional[LatticeMesh] = None,
                              reps: int = 5, recorder=None, seed: int = 0,
                              device="cuda") -> LQCDCalibration:
    """Time the executed normal op and put it on the telemetry bus.

    Draws a random gauge field and source on ``device`` from ``seed``
    (``random_field_and_source``) and applies the Schur normal op A†A
    once to build and warm the kernels: on ``device`` alone with
    ``mesh=None``, else :meth:`ShardedWilsonEO.normal` over ``mesh`` (the
    fields split from ``device`` onto the shards).  Then it times ``reps``
    applications: with CUDA events when all the work is on ``device``'s
    one card (``mesh=None``, or every shard there), else on the host clock
    with every device synchronised before and after, since events on one
    stream cannot span several cards (the CPU is timed by the host clock).  Wall time becomes sustained GFLOPS and streaming bandwidth by
    the same counts as the JAX function; the run is emitted into
    ``recorder`` (or a private bus) and joules are integrated from the
    trace.

    Differences from the JAX function, on purpose:

      * busy watts: it pairs its measured rate with S9150 watts at an
        operating point; this one takes the H100 table's HBM-bound watts
        (``H100_SXM``), measured on the card the rate is measured on;
      * ``n_devices`` (and with it busy watts, ``n_devices`` × the
        table's) counts the *distinct* devices the shards sit on: four
        shards on one card bill one card.  The JAX function counts the
        mesh size, which there equals its device count;
      * ``mesh=None`` times the one-device op; the JAX function then
        shards over every local device.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    lattice = tuple(int(s) for s in lattice)
    U, b = random_field_and_source(lattice, seed, dev)
    U_e, U_o = pack_gauge(U)
    if mesh is None:
        devices = (dev,)

        def normal(v: torch.Tensor) -> torch.Tensor:
            return schur_matvec_dagger(
                U_e, U_o, schur_matvec(U_e, U_o, v, kappa), kappa)
    else:
        normal = ShardedWilsonEO(U_e, U_o, kappa, mesh).normal
        devices = mesh.distinct_devices
    n_dev = len(devices)

    v = normal(eo_pack(b, 0))                # build + warm
    synced = tuple(dict.fromkeys(devices + (dev,)))
    _synchronize(synced)
    if synced == (dev,) and dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(reps):
            v = normal(v)
        end.record(stream)
        end.synchronize()
        wall = start.elapsed_time(end) / 1e3
    else:
        t_start = time.perf_counter()
        for _ in range(reps):
            v = normal(v)
        _synchronize(synced)
        wall = time.perf_counter() - t_start
    wall = max(wall, 1e-9)

    volume = int(np.prod(lattice))
    flops = reps * 2 * volume * dslash_flops_per_site()
    streamed = reps * 2 * volume * dslash_bytes_per_site(4)
    gflops = flops / wall / 1e9
    busy_w = n_dev * h100_chip_power(1.0, 0.0, 1.0, H100_SXM)

    rec = recorder if recorder is not None \
        else TraceRecorder(source="lqcd-calibration")
    t0 = rec.t_last
    for t in (t0, t0 + wall):
        rec.emit(t, {"gpu": busy_w}, flops_rate=gflops, util=1.0)
    trace = rec.trace()
    energy_j = trace.energy_j(t0=t0, t1=t0 + wall)
    return LQCDCalibration(lattice, n_dev, gflops, streamed / wall / 1e9,
                           busy_w, wall, energy_j, source="measured",
                           trace=trace)
