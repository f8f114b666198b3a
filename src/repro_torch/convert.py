"""Carry-over between the JAX package's arrays and the port's tensors.

The JAX package's arrays arrive as numpy (``np.asarray(U)``); these
helpers check their layout and place them on a device, and bring results
back.  Layouts are the JAX package's:

  psi: (X, Y, Z, T, 4, 3) complex64   (half-fields: (X/2, Y, Z, T, 4, 3))
  U:   (4, X, Y, Z, T, 3, 3) complex64
  HPL: a (n, n) float32; an LU factorization as its packed ``lu`` (n, n)
       float32 and ``piv`` (n // nb, nb) int32
  LM:  the ``init_params`` tree of any family (nested dicts, layers
       stacked on a leading axis), both ways, and the decode cache dict,
       as float32 numpy arrays (an int8 K/V cache as int8)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.hpl.lu import LUResult
from repro_torch.models.layers import param_dtype
from repro_torch.models.transformer import Model, empty_params


def _from_numpy(a, tail: tuple, lead: int, what: str,
                device) -> torch.Tensor:
    a = np.asarray(a)
    if a.ndim != lead + 4 + len(tail) or a.shape[lead + 4:] != tail:
        raise ValueError(f"{what} must have shape "
                         f"{('4,' if lead else '')}(X, Y, Z, T){tail}, "
                         f"got {a.shape}")
    # a copy: the caller's array (often a read-only view of a JAX array)
    # never aliases the port's tensor
    a = np.array(a, dtype=np.complex64, order="C")
    return torch.from_numpy(a).to(resolve_device(device))


def gauge_from_numpy(U, device="cuda") -> torch.Tensor:
    """A (4, X, Y, Z, T, 3, 3) gauge field as a complex64 tensor."""
    if np.shape(U)[:1] != (4,):
        raise ValueError(f"gauge field needs 4 directions, got "
                         f"{np.shape(U)}")
    return _from_numpy(U, (3, 3), 1, "gauge field", device)


def spinor_from_numpy(psi, device="cuda") -> torch.Tensor:
    """A (X, Y, Z, T, 4, 3) spinor (or compact half-) field as a complex64
    tensor."""
    return _from_numpy(psi, (4, 3), 0, "spinor field", device)


def matrix_from_numpy(a, device="cuda") -> torch.Tensor:
    """A 2-D matrix as a float32 tensor (a copy)."""
    a = np.array(a, dtype=np.float32, order="C")
    if a.ndim != 2:
        raise ValueError(f"a matrix must be 2-D, got shape {a.shape}")
    return torch.from_numpy(a).to(resolve_device(device))


def lu_from_numpy(lu, piv, device="cuda") -> LUResult:
    """The JAX package's ``LUResult`` arrays as the port's ``LUResult``."""
    lu_t = matrix_from_numpy(lu, device)
    piv = np.asarray(piv)
    n = lu_t.shape[0]
    if lu_t.shape[1] != n or piv.ndim != 2 or piv.size != n:
        raise ValueError(f"lu must be (n, n) and piv (n // nb, nb), got "
                         f"{lu_t.shape} and {piv.shape}")
    piv_t = torch.from_numpy(piv.astype(np.int32)).to(lu_t.device)
    return LUResult(lu_t, piv_t, piv.shape[0])


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on any device as a numpy array."""
    return t.detach().cpu().numpy()


def _load(module: torch.nn.Module, tree: dict, what: str,
          index: int | None = None) -> None:
    """Copy ``tree``'s arrays (layer ``index`` of stacked ones) into the
    parameters of the same names, and its sub-dicts into the submodules of
    the same names, each array cast to its parameter's dtype."""
    names = dict(module.named_parameters(recurse=False))
    children = dict(module.named_children())
    if set(tree) != set(names) | set(children):
        raise ValueError(f"{what}: the tree has {sorted(tree)}, the port's "
                         f"module {sorted(set(names) | set(children))}")
    for k, p in names.items():
        a = np.asarray(tree[k])
        if a.dtype != np.float32:
            raise TypeError(f"{what}.{k}: pass float32 arrays, got {a.dtype}")
        if index is not None:
            a = a[index]
        if a.shape != tuple(p.shape):
            raise ValueError(f"{what}.{k} must have shape {tuple(p.shape)}, "
                             f"got {a.shape}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(a, order="C")))
    for k, child in children.items():
        _load(child, tree[k], f"{what}.{k}", index)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> Model:
    """The JAX package's ``init_params(cfg, key)`` tree, for any family, as
    the port's model.

    The arrays must be float32 (``np.asarray(a, np.float32)``): each is
    cast to its parameter's dtype on the way in, so bfloat16 weights come
    back bit for bit.  Layers (``layers``, ``enc_layers``), stacked on a
    leading axis in the tree, are unstacked."""
    model = empty_params(cfg, device)
    children = dict(model.named_children())
    if set(tree) != set(children):
        raise ValueError(f"the tree has {sorted(tree)}, the port's model "
                         f"{sorted(children)}")
    for name, child in children.items():
        if isinstance(child, torch.nn.ModuleList):
            for i, layer in enumerate(child):
                _load(layer, tree[name], name, i)
        else:
            _load(child, tree[name], name)
    return model


def param_names(model: Model) -> dict:
    """The JAX package's ``init_params`` tree of the model's parameter
    names (as ``model.named_parameters()`` names them): nested dicts whose
    leaves are a name, or under a layer list (``layers``, ``enc_layers``)
    a tuple of one name a layer, the JAX tree's leading layer axis."""
    def walk(module: torch.nn.Module, prefix: str) -> dict:
        out = {k: prefix + k
               for k, _ in module.named_parameters(recurse=False)}
        for k, child in module.named_children():
            out[k] = walk(child, f"{prefix}{k}.")
        return out

    def stack(trees: list):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return tuple(trees)

    tree = {}
    for name, child in model.named_children():
        tree[name] = (stack([walk(layer, f"{name}.{i}.")
                             for i, layer in enumerate(child)])
                      if isinstance(child, torch.nn.ModuleList)
                      else walk(child, f"{name}."))
    return tree


def params_to_numpy(model: Model, cfg: ModelConfig,
                    tensors: dict | None = None) -> dict:
    """The inverse of ``params_from_numpy``: the port's model as the JAX
    package's ``init_params`` tree of float32 numpy arrays, its layers
    stacked on a leading axis.  ``tensors``, keyed by parameter name as
    ``model.named_parameters()`` names them (gradients, AdamW moments),
    gives the arrays in the parameters' places."""
    named = dict(model.named_parameters()) if tensors is None else tensors

    def arrays(tree):
        if isinstance(tree, dict):
            return {k: arrays(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return np.stack([to_numpy(named[n].float()) for n in tree])
        return to_numpy(named[tree].float())

    if len(model.layers) != cfg.n_layers:
        raise ValueError(f"the model has {len(model.layers)} layers, its "
                         f"configuration {cfg.n_layers}")
    return arrays(param_names(model))


# the decode cache's entries: those kept in float32, and those in the
# model's dtype unless they arrive as int8 (the int8 K/V cache)
_F32_CACHE_KEYS = ("ssm", "k_s", "v_s")
_CACHE_KEYS = ("k", "v", "ckv", "krope", "xk", "xv", "conv") \
    + _F32_CACHE_KEYS


def cache_from_numpy(cache: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The JAX package's decode cache, for any family, as the port's:
    ``pos`` an int32 scalar, ``ssm``, ``k_s`` and ``v_s`` float32, ``k``
    and ``v`` int8 where the cache has scales (the int8 K/V cache), the
    rest in the model's dtype.  Pass the arrays as float32 (int8 ones may
    come as int8)."""
    dev = resolve_device(device)
    unknown = set(cache) - {"pos", *_CACHE_KEYS}
    if "pos" not in cache or unknown:
        raise ValueError(f"a decode cache has pos and some of "
                         f"{list(_CACHE_KEYS)}, got {sorted(cache)}")
    int8 = ("k", "v") if "k_s" in cache else ()
    out = {"pos": torch.tensor(int(np.asarray(cache["pos"])),
                               dtype=torch.int32, device=dev)}
    for k, a in cache.items():
        if k == "pos":
            continue
        t = torch.from_numpy(np.array(a, np.float32, order="C")).to(dev)
        out[k] = (t if k in _F32_CACHE_KEYS else
                  t.to(torch.int8 if k in int8 else param_dtype(cfg)))
    return out
