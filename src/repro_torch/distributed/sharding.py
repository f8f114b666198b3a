"""Sharding rules and the single-controller mesh: FSDP (data/pod axes) ×
TP (model axis) × EP for the LM path, and the T axis of the lattice.

The counterpart of the JAX package's ``distributed/sharding.py``.  A JAX
mesh is single-controller: one process drives every local device through
``shard_map`` and GSPMD.  The port keeps that model.  An :class:`LMMesh`
gives each coordinate of an N-D mesh a device, round-robin over the
devices it is given, so one card can hold several coordinates, as the JAX
package's tests place theirs on virtual CPU devices of one host.  A
:class:`ShardedTensor` holds each coordinate's block of a tensor on that
coordinate's device; blocks that are equal (replicas over an axis the
spec does not name) and sit on one device are one tensor.

LM rules.  Every rule is a *candidate list*: the first :class:`P` whose
sharded dims all divide evenly on the mesh wins, so one rule set serves
whisper (12 heads, 51865 vocab) and grok (48 heads, 8 KV heads) alike.
``param_pspecs`` works on the port's per-layer ``Model`` and gives each
parameter the reference's spec with the stacked layer axis taken out.
The serve budget that decides ``serve_tp_only`` is the port's: 75% of
the H100's 80 GB (the reference's 12 GiB sits below a 16 GiB TPU chip);
pass ``budget=`` for another.

Lattice rules: the T axis split over a 1-D :class:`LatticeMesh`, whose
shard ``i`` lives on ``devices[i]``.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.config import MeshConfig, ModelConfig
from repro_torch.roofline import hw

TP = "model"

# the bytes of TP-sharded weights a card may hold for serving without the
# FSDP factors: 75% of the H100's 80 GB (memplan's budget)
SERVE_TP_ONLY_BUDGET = int(0.75 * hw.HBM_PER_CHIP)


# ---------------------------------------------------------------------------
# Partition specs and the mesh
# ---------------------------------------------------------------------------

def _norm_axis(axis):
    """An entry as JAX's ``PartitionSpec`` keeps it: a one-name tuple is
    the name, an empty tuple None."""
    if isinstance(axis, (tuple, list)):
        axis = tuple(axis)
        return axis[0] if len(axis) == 1 else (axis or None)
    return axis


class P(tuple):
    """A partition spec: one entry per leading tensor dim, each an axis
    name, a tuple of names (the dim split over them, the first slowest)
    or None; dims past its length are not split.  ``tuple(P(...))``
    equals ``tuple`` of the JAX package's ``PartitionSpec`` with the same
    entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_norm_axis(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True, eq=False)
class LMMesh:
    """An N-D mesh of ``shape`` over ``axis_names``; coordinate ``c`` (row
    major, the last axis fastest) lives on ``devices[flat(c)]``.
    ``calls`` logs each collective of ``distributed.collectives`` over
    this mesh: its calls, result bytes and ring bytes, by (name, axis)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]
    calls: Dict[Tuple[str, str], Dict[str, int]] = field(
        default_factory=dict, repr=False)

    @property
    def traffic(self) -> Dict[str, int]:
        """The ring bytes each collective moved over this mesh, by name,
        summed over its axes."""
        out: Dict[str, int] = {}
        for (name, _), rec in self.calls.items():
            out[name] = out.get(name, 0) + rec["wire_bytes"]
        return out

    def size(self, axis=None) -> int:
        """The coordinates along ``axis`` (a name, a tuple of names, or
        None: the whole mesh)."""
        if axis is None:
            return math.prod(self.shape)
        return _axis_size(self, axis)

    def coords(self) -> List[Tuple[int, ...]]:
        return list(itertools.product(*(range(n) for n in self.shape)))

    def device(self, coord: Tuple[int, ...]) -> torch.device:
        flat = 0
        for i, n in zip(coord, self.shape):
            flat = flat * n + i
        return self.devices[flat]

    def index(self, coord: Tuple[int, ...], axis) -> int:
        """``coord``'s position along ``axis``; along a tuple of axes, the
        row-major position over them (``lax.axis_index`` of each, the
        first slowest)."""
        if isinstance(axis, (tuple, list)):
            idx = 0
            for a in axis:
                idx = idx * self.size(a) + self.index(coord, a)
            return idx
        if axis not in self.axis_names:
            raise ValueError(f"axis {axis!r} is not one of the mesh's "
                             f"{self.axis_names}")
        return coord[self.axis_names.index(axis)]

    @property
    def config(self) -> MeshConfig:
        return MeshConfig(tuple(self.shape), tuple(self.axis_names))

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The devices the coordinates sit on, each once, in order."""
        return tuple(dict.fromkeys(self.devices))


def _devices(devices: Optional[Sequence]) -> List[torch.device]:
    if devices is None:
        k = torch.cuda.device_count()
        if k == 0:
            raise RuntimeError(
                "no CUDA device is available; pass devices=('cpu',) to "
                "build the mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(k)]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"a mesh takes devices of one type, got {devices}")
    return devices


def lm_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
            devices: Optional[Sequence] = None) -> LMMesh:
    """An :class:`LMMesh` whose coordinates go round-robin over
    ``devices`` (default: every visible card, raising without one; pass
    ``devices=("cpu",)`` for the CPU): a (2, 2) mesh on one card is four
    coordinates on ``cuda:0``."""
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(shape):
        raise ValueError(f"a mesh needs one distinct name per axis, got "
                         f"{shape} and {axis_names}")
    devs = _devices(devices)
    n = math.prod(shape)
    return LMMesh(shape, axis_names,
                  tuple(devs[i % len(devs)] for i in range(n)))


# ---------------------------------------------------------------------------
# Placement: shardings and sharded tensors
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class Sharding:
    """``spec`` over ``mesh`` (``NamedSharding``'s counterpart)."""

    mesh: LMMesh
    spec: P

    def block(self, coord, ndim: int) -> Tuple[Tuple[int, int], ...]:
        """(block index, block count) of each of ``ndim`` dims at
        ``coord``."""
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"tensor's {ndim} dims")
        out = []
        for axis in tuple(self.spec) + (None,) * (ndim - len(self.spec)):
            if axis is None:
                out.append((0, 1))
            else:
                out.append((self.mesh.index(coord, axis),
                            self.mesh.size(axis)))
        return tuple(out)


@dataclass(eq=False)
class ShardedTensor:
    """A tensor of ``shape`` placed under ``sharding``: ``shards`` maps each
    mesh coordinate to its block, on that coordinate's device."""

    sharding: Sharding
    shape: torch.Size
    shards: Dict[Tuple[int, ...], torch.Tensor]

    @property
    def mesh(self) -> LMMesh:
        return self.sharding.mesh

    @property
    def spec(self) -> P:
        return self.sharding.spec

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.shards.values())).dtype

    def blocks(self) -> Dict[tuple, torch.Tensor]:
        """One tensor per distinct block (the first coordinate's that holds
        it), keyed by its block index per dim."""
        out = {}
        for c in self.mesh.coords():
            key = tuple(i for i, _ in self.sharding.block(c, len(self.shape)))
            out.setdefault(key, self.shards[c])
        return out

    @classmethod
    def from_shards(cls, sharding: Sharding,
                    shards: Dict[tuple, torch.Tensor]) -> "ShardedTensor":
        """Per-coordinate blocks (a ``shard_map`` body's outputs) as the
        tensor they make up under ``sharding``."""
        c0 = sharding.mesh.coords()[0]
        blk = shards[c0]
        counts = [n for _, n in sharding.block(c0, blk.dim())]
        shape = torch.Size(s * n for s, n in zip(blk.shape, counts))
        return cls(sharding, shape, dict(shards))


def shard_tensor(x: torch.Tensor, sharding: Sharding, *,
                 copy: bool = False) -> ShardedTensor:
    """``x``'s block of each coordinate, on the coordinate's device: a
    view where the device is ``x``'s (autograd flows back to ``x``), or
    with ``copy`` a contiguous tensor of its own.  Every split dim must
    divide evenly, as ``jax.device_put`` requires."""
    mesh, shape = sharding.mesh, x.shape
    shards, made = {}, {}
    for c in mesh.coords():
        blk = sharding.block(c, x.dim())
        dev = mesh.device(c)
        key = (tuple(i for i, _ in blk), dev)
        if key not in made:
            t = x
            for d, ((i, n), size) in enumerate(zip(blk, shape)):
                if n > 1:
                    if size % n:
                        raise ValueError(
                            f"dim {d} of a {tuple(shape)} tensor does not "
                            f"split into {n} blocks under {sharding.spec}")
                    t = t.narrow(d, i * (size // n), size // n)
            made[key] = (torch.empty(t.shape, dtype=t.dtype,
                                     device=dev).copy_(t) if copy
                         else t.to(dev))
        shards[c] = made[key]
    return ShardedTensor(sharding, torch.Size(shape), shards)


def unshard_tensor(st: ShardedTensor, device=None) -> torch.Tensor:
    """The whole tensor on ``device`` (default: the mesh's first), made of
    one block per distinct block index (differentiable: the gradient of
    each block lands on its shard)."""
    dev = torch.device(device) if device is not None else st.mesh.devices[0]
    blocks = st.blocks()
    counts = [n for _, n in st.sharding.block(st.mesh.coords()[0],
                                              len(st.shape))]

    def cat(prefix: tuple, d: int) -> torch.Tensor:
        if d == len(counts):
            return blocks[prefix].to(dev)
        parts = [cat(prefix + (i,), d + 1) for i in range(counts[d])]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)

    return cat((), 0)


def _is_tensor_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, ShardedTensor))


def shard_tree(tree: Any, shardings: Any) -> Any:
    """Place every tensor of ``tree`` under the :class:`Sharding` in the
    same place of ``shardings``, each block a copy of its own (the
    caller's tensors are never written through it).  A port ``Model``
    (any ``nn.Module``) becomes ``{parameter name: ShardedTensor}`` under
    ``{parameter name: Sharding}`` (``named_shardings(mesh,
    param_pspecs(...))``)."""
    if isinstance(tree, nn.Module):
        tree = {k: p.detach() for k, p in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: shard_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, ShardedTensor):
        tree = unshard_tensor(tree)
    return shard_tensor(tree.detach(), shardings, copy=True)


def unshard_tree(tree: Any, device=None) -> Any:
    """Every :class:`ShardedTensor` of ``tree`` as its whole tensor on
    ``device``."""
    if isinstance(tree, dict):
        return {k: unshard_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, ShardedTensor):
        return unshard_tensor(tree, device)
    return tree


def named_shardings(mesh: LMMesh, pspecs: Any) -> Any:
    """``pspecs``' structure with a :class:`Sharding` over ``mesh`` in each
    spec's place."""
    if isinstance(pspecs, P):
        return Sharding(mesh, pspecs)
    return {k: named_shardings(mesh, v) for k, v in pspecs.items()}


# ---------------------------------------------------------------------------
# LM rules
# ---------------------------------------------------------------------------

def data_axes_of(mesh_cfg: MeshConfig) -> Tuple[str, ...]:
    return mesh_cfg.data_axes


def _axis_size(mesh_cfg, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= _axis_size(mesh_cfg, a)
        return n
    return mesh_cfg.shape[mesh_cfg.axis_names.index(axis)]


def fits(shape: Sequence[int], spec: P, mesh_cfg) -> bool:
    for dim, axis in zip(shape, tuple(spec) + (None,) * len(shape)):
        size = _axis_size(mesh_cfg, axis)
        if size > 1 and dim % size != 0:
            return False
    return True


def pick(shape: Sequence[int], candidates: List[P], mesh_cfg) -> P:
    for c in candidates:
        if fits(shape, c, mesh_cfg):
            return c
    return P()


def _param_rule(cfg: ModelConfig, mesh_cfg: MeshConfig,
                path: Tuple[str, ...], shape: Sequence[int]) -> P:
    from repro_torch.models.moe import moe_sharding_plan

    dp = data_axes_of(mesh_cfg)
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""

    if parent == "embed":                         # (V, D)
        return pick(shape, [P(TP, dp), P(TP, None), P(None, TP), P(dp, None)],
                    mesh_cfg)
    if parent == "lm_head":                       # (D, V)
        return pick(shape, [P(dp, TP), P(None, TP), P(dp, None)], mesh_cfg)
    if parent == "frontend":
        if name == "proj_w":
            return pick(shape, [P(dp, TP), P(None, TP)], mesh_cfg)
        return P()

    if parent in ("attn", "xattn"):
        if name == "wq":                          # (D, H, dh)
            return pick(shape, [P(dp, TP, None), P(dp, None, TP),
                                P(None, None, TP)], mesh_cfg)
        if name in ("wk", "wv"):                  # (D, KVH, dh)
            return pick(shape, [P(dp, TP, None), P(dp, None, TP),
                                P(None, None, TP)], mesh_cfg)
        if name == "wo":                          # (H, dh, D)
            return pick(shape, [P(TP, None, dp), P(None, TP, dp),
                                P(None, TP, None)], mesh_cfg)
        if name in ("bq", "bk", "bv"):            # (H, dh)
            return pick(shape, [P(TP, None), P(None, TP)], mesh_cfg)
        # MLA
        if name in ("wq_a", "wkv_a"):             # (D, r)
            return pick(shape, [P(dp, None)], mesh_cfg)
        if name == "wq_b":                        # (r, H, qk)
            return pick(shape, [P(dp, TP, None), P(None, TP, None)], mesh_cfg)
        if name in ("wkv_b_nope", "wkv_b_v"):     # (r, H, x)
            return pick(shape, [P(dp, TP, None), P(None, TP, None)], mesh_cfg)
        return P()                                # norms

    if parent == "moe":
        if name == "router":
            return P()
        plan = moe_sharding_plan(cfg, _axis_size(mesh_cfg, TP))
        if name in ("w_gate", "w_up"):            # (E, D, F)
            if plan == "expert":
                return pick(shape, [P(TP, dp, None), P(TP, None, None)],
                            mesh_cfg)
            return pick(shape, [P(None, dp, TP), P(None, None, TP)], mesh_cfg)
        if name == "w_down":                      # (E, F, D)
            if plan == "expert":
                return pick(shape, [P(TP, None, dp), P(TP, None, None)],
                            mesh_cfg)
            return pick(shape, [P(None, TP, dp), P(None, TP, None)], mesh_cfg)
        if name in ("shared_gate", "shared_up"):  # (D, F)
            return pick(shape, [P(dp, TP), P(None, TP)], mesh_cfg)
        if name == "shared_down":                 # (F, D)
            return pick(shape, [P(TP, dp), P(TP, None)], mesh_cfg)

    if parent == "mlp":
        if name in ("w_gate", "w_up"):            # (D, F)
            return pick(shape, [P(dp, TP), P(None, TP), P(dp, None)],
                        mesh_cfg)
        if name == "w_down":                      # (F, D)
            return pick(shape, [P(TP, dp), P(TP, None), P(None, dp)],
                        mesh_cfg)

    if parent == "ssm":
        if name == "w_in":                        # (D, E)
            return pick(shape, [P(dp, None)], mesh_cfg)
        if name == "w_out":                       # (E, D)
            return pick(shape, [P(None, dp)], mesh_cfg)
        return P()

    return P()                                    # norms, scalars


def _path_names(name: str) -> Tuple[str, ...]:
    """A parameter name (``layers.3.attn.wq``) as the reference's tree
    path, the layer index dropped (``layers``, ``attn``, ``wq``)."""
    return tuple(p for p in name.split(".") if not p.isdigit())


def param_bytes(params: nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())


def _strip_dp(spec: P, dp: Tuple[str, ...]) -> P:
    drop = set(dp)

    def clean(axis):
        if axis is None:
            return None
        if isinstance(axis, (tuple, list)):
            kept = tuple(a for a in axis if a not in drop)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return None if axis in drop else axis

    return P(*[clean(a) for a in spec])


def param_pspecs(cfg: ModelConfig, params: nn.Module, mesh_cfg: MeshConfig,
                 mode: str = "train", serve_tp_only: Optional[bool] = None,
                 moe_ep_data: bool = False,
                 budget: int = SERVE_TP_ONLY_BUDGET) -> Dict[str, P]:
    """``{parameter name: P}`` for the port's ``Model`` (on any device,
    ``meta`` included): the reference's specs with its stacked layer axis
    taken out (the reference prepends ``None`` under ``layers`` and
    ``enc_layers``).

    ``mode='serve'``: when the TP-sharded weights fit ``budget`` bytes a
    card, drop the FSDP (data/pod) factors so serving never gathers
    weights a step; models too large for TP-only (grok, deepseek) keep
    FSDP.  ``moe_ep_data``: experts over the data axes, the FFN over
    model, fully resident."""
    tp_only = False
    if mode == "serve":
        if serve_tp_only is not None:
            tp_only = serve_tp_only
        else:
            tp_only = (param_bytes(params) // _axis_size(mesh_cfg, TP)
                       <= budget)
    dp = data_axes_of(mesh_cfg)

    def rule(name: str, shape) -> P:
        names = _path_names(name)
        spec = _param_rule(cfg, mesh_cfg, names, shape)
        if moe_ep_data and len(names) >= 2 and names[-2] == "moe":
            # serve-EP: experts over data, FFN over model, fully resident
            if names[-1] in ("w_gate", "w_up"):
                spec = pick(shape, [P(dp, None, TP), P(dp, None, None)],
                            mesh_cfg)
            elif names[-1] == "w_down":
                spec = pick(shape, [P(dp, TP, None), P(dp, None, None)],
                            mesh_cfg)
        elif tp_only:
            spec = _strip_dp(spec, dp)
        return spec

    return {k: rule(k, tuple(p.shape)) for k, p in params.named_parameters()}


def batch_pspecs(cfg: ModelConfig, batch_shapes: Dict[str, Any],
                 mesh_cfg: MeshConfig) -> Dict[str, P]:
    dp = data_axes_of(mesh_cfg)
    out = {}
    for k, v in batch_shapes.items():
        cands = [P(dp, *([None] * (len(v.shape) - 1))), P()]
        out[k] = pick(v.shape, cands, mesh_cfg)
    return out


def cache_pspecs(cfg: ModelConfig, cache_shapes: Dict[str, Any],
                 mesh_cfg: MeshConfig) -> Dict[str, P]:
    """Decode-cache sharding: batch over data, sequence (or heads) over
    model (the cache's layer axis, stacked as in the reference, is never
    split)."""
    dp = data_axes_of(mesh_cfg)
    out: Dict[str, P] = {}
    for k, v in cache_shapes.items():
        if k == "pos":
            out[k] = P()
        elif k in ("k", "v", "xk", "xv"):          # (L, B, S, KVH, dh)
            kvh = v.shape[3]
            cands = [
                P(None, dp, TP, None, None),
                P(None, None, TP, None, None),
                P(None, dp, None, None, None),
            ]
            if kvh % _axis_size(mesh_cfg, TP) != 0:
                # heads don't shard: shard head_dim instead
                cands.insert(0, P(None, dp, None, None, TP))
            out[k] = pick(v.shape, cands, mesh_cfg)
        elif k in ("ckv", "krope"):                # (L, B, S, r)
            out[k] = pick(v.shape, [
                P(None, dp, TP, None),
                P(None, None, TP, None),
            ], mesh_cfg)
        elif k == "ssm":                           # (L, B, H, P, N)
            out[k] = pick(v.shape, [
                P(None, dp, TP, None, None),
                P(None, dp, None, None, None),
                P(None, None, TP, None, None),
            ], mesh_cfg)
        elif k in ("k_s", "v_s"):                  # (L, B, S) per-token
            out[k] = pick(v.shape, [P(None, dp, None)], mesh_cfg)
        elif k == "conv":                          # (L, B, K-1, C)
            out[k] = pick(v.shape, [P(None, dp, None, None)], mesh_cfg)
        else:
            out[k] = P()
    return out


# ---------------------------------------------------------------------------
# Lattice (LQCD) rules: T-axis sharding for the even-odd solver
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LatticeMesh:
    """Shard ``i`` of the lattice's T axis lives on ``devices[i]``."""

    devices: Tuple[torch.device, ...]

    @property
    def n(self) -> int:
        """The shard count (the JAX mesh's axis size)."""
        return len(self.devices)

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The devices the shards sit on, each once, in shard order."""
        return tuple(dict.fromkeys(self.devices))


def lattice_mesh(t_extent: int, n_devices: Optional[int] = None, *,
                 devices: Optional[Sequence] = None) -> LatticeMesh:
    """1-D mesh for lattice T-sharding.

    Picks the largest shard count (≤ ``n_devices``, else ≤ the number of
    ``devices``) that divides ``t_extent``, as the JAX function does: the
    halo ring assumes equal local T blocks.  ``devices`` defaults to every
    visible card (``cuda:0 … cuda:k-1``) and raises without one; pass
    ``devices=("cpu",)`` for the CPU.  Shards go round-robin over
    ``devices``: ``lattice_mesh(64, 4)`` on one card is four shards on
    ``cuda:0``.
    """
    if devices is None:
        k = torch.cuda.device_count()
        if k == 0:
            raise RuntimeError(
                "no CUDA device is available; pass devices=('cpu',) to "
                "shard the lattice on the CPU")
        devices = [torch.device("cuda", i) for i in range(k)]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("lattice_mesh needs at least one device")
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"a lattice mesh takes devices of one type, got "
                         f"{devices}")
    avail = n_devices or len(devices)
    n = max(d for d in range(1, avail + 1) if t_extent % d == 0)
    return LatticeMesh(tuple(devices[i % len(devices)] for i in range(n)))


def lattice_eo_specs() -> Tuple[int, int]:
    """(gauge-half, spinor-half) split axes of the compact even-odd layout:
    T is axis 4 of a gauge half ``(4, X/2, Y, Z, T, 3, 3)`` and axis 3 of
    a spinor half ``(X/2, Y, Z, T, 4, 3)`` (the JAX function's
    ``PartitionSpec``\\ s name the same axes)."""
    return 4, 3


def split_t_blocks(x: torch.Tensor, mesh: LatticeMesh,
                   axis: int) -> list:
    """Cut a global tensor into the mesh's equal T-blocks along ``axis``,
    each a contiguous tensor on its shard's device."""
    T = x.shape[axis]
    if T % mesh.n:
        raise ValueError(f"T extent {T} is not divisible by the {mesh.n} "
                         f"shards of the mesh")
    tl = T // mesh.n
    return [x.narrow(axis, i * tl, tl).to(d).contiguous()
            for i, d in enumerate(mesh.devices)]


def gather_t_blocks(blocks: Sequence[torch.Tensor], axis: int,
                    device) -> torch.Tensor:
    """The inverse of :func:`split_t_blocks`: one tensor on ``device``."""
    return torch.cat([b.to(device) for b in blocks], dim=axis)
