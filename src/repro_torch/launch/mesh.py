"""Production and smoke meshes: the counterpart of the JAX package's
``launch/mesh.py``, returning single-controller :class:`LMMesh`\\ es.

Building a production mesh describes it: its 256 or 512 coordinates go
round-robin over the visible devices (``devices=`` to choose them), so
on one card every coordinate is ``cuda:0``; nothing is allocated.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.config import MULTI_POD_MESH, SINGLE_POD_MESH, MeshConfig
from repro_torch.distributed.sharding import LMMesh, lm_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> LMMesh:
    """16 x 16 single pod (256 coordinates) or 2 x 16 x 16 multi-pod
    (512)."""
    return make_mesh_from_config(mesh_config(multi_pod=multi_pod),
                                 devices=devices)


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD_MESH if multi_pod else SINGLE_POD_MESH


def make_mesh_from_config(mesh_cfg: MeshConfig, *,
                          devices: Optional[Sequence] = None) -> LMMesh:
    return lm_mesh(mesh_cfg.shape, mesh_cfg.axis_names, devices=devices)


def make_smoke_mesh(n_data: int = 2, n_model: int = 2, *,
                    devices: Optional[Sequence] = None) -> LMMesh:
    """A small ("data", "model") mesh for the tests and the smoke runs."""
    return lm_mesh((n_data, n_model), ("data", "model"), devices=devices)
