"""int8 gradient compression with error feedback for cross-pod data
parallelism: the counterpart of the JAX package's
``optim/grad_compress.py``.

The pod axis rides slower links than the links inside a pod; compressing
the cross-pod gradient all-reduce 4x (float32 -> int8 and a per-tensor
scale) recovers most of it.  Error feedback (Seide et al.) keeps the
quantization residual on each pod, so the compression's bias vanishes
over steps.

Over a single-controller ``LMMesh`` with a ``pod`` axis, a leaf is a
``ShardedTensor`` whose shards may differ from pod to pod (each pod's
partial mean), or a tensor that every coordinate holds alike; the mean
over the pod axis runs through ``distributed.collectives``.  Any other
axes of the mesh only repeat the collective (the reference's
``shard_map`` over pod alone fails on such meshes under jax 0.9).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.distributed.collectives import pmean, psum
from repro_torch.distributed.sharding import ShardedTensor


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp_min(torch.amax(torch.abs(x)) / 127.0, 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum_leaf(mesh, g: Dict, err: Dict, axis: str = "pod",
                         ) -> Tuple[Dict, Dict]:
    """One leaf, per coordinate (``{coord: tensor}``): quantize(g + err)
    -> psum of the int8 values as int32 -> dequantize with the mean
    scale; returns (the reduced gradient, the new error feedback), each
    per coordinate."""
    n = mesh.size(axis)
    g_fb, q, scale = {}, {}, {}
    for c in mesh.coords():
        g_fb[c] = g[c].to(torch.float32) + err[c]
        q[c], scale[c] = quantize_int8(g_fb[c])
    # int8 sums overflow int8: sum as int32, and take the mean scale
    q_sum = psum(mesh, {c: t.to(torch.int32) for c, t in q.items()}, axis)
    scale_mean = pmean(mesh, scale, axis)
    # error feedback measures against the dequantization the sum used
    # (the mean scale), or the scales' skew across pods is a bias the
    # feedback never sees.  g_fb - q * scale rounded once, as XLA fuses
    # it: the float64 product of an int8 and a float32 is exact
    new_err = {c: (g_fb[c].double() - q[c].double()
                   * scale_mean[c].double()).float()
               for c in mesh.coords()}
    g_red = {c: q_sum[c].to(torch.float32) * scale_mean[c] / n
             for c in mesh.coords()}
    return g_red, new_err


def _per_coord(mesh, leaf) -> Dict:
    if isinstance(leaf, ShardedTensor):
        return dict(leaf.shards)
    return {c: leaf.to(mesh.device(c)) for c in mesh.coords()}


def _like(mesh, leaf, vals: Dict):
    if isinstance(leaf, ShardedTensor):
        return ShardedTensor(leaf.sharding, leaf.shape, vals)
    return vals[mesh.coords()[0]].to(leaf.device)


def compressed_pod_mean(grads: Any, err_state: Any, mesh,
                        data_axes=("data",), pod_axis: str = "pod",
                        ) -> Tuple[Any, Any]:
    """The compressed mean over ``pod_axis`` of every leaf of ``grads``
    (a dict tree of tensors or ``ShardedTensor``\\ s), with the error
    feedback of ``err_state`` (the same structure); returns (the means,
    the new error state), each leaf as it came.  ``data_axes`` is the
    reference's argument (the gradients' FSDP axes) and changes
    nothing."""
    if pod_axis not in mesh.axis_names:
        raise ValueError(f"the mesh's axes {mesh.axis_names} have no "
                         f"{pod_axis!r} axis")
    if isinstance(grads, dict):
        outs = {k: compressed_pod_mean(grads[k], err_state[k], mesh,
                                       data_axes, pod_axis) for k in grads}
        return ({k: o[0] for k, o in outs.items()},
                {k: o[1] for k, o in outs.items()})
    g_red, new_err = compressed_psum_leaf(
        mesh, _per_coord(mesh, grads), _per_coord(mesh, err_state),
        pod_axis)
    return _like(mesh, grads, g_red), _like(mesh, err_state, new_err)


def init_error_state(grads_like: Any) -> Any:
    """Zero float32 error feedback shaped as each leaf."""
    if isinstance(grads_like, dict):
        return {k: init_error_state(v) for k, v in grads_like.items()}
    if isinstance(grads_like, ShardedTensor):
        return ShardedTensor(grads_like.sharding, grads_like.shape, {
            c: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for c, t in grads_like.shards.items()})
    return torch.zeros(grads_like.shape, dtype=torch.float32,
                       device=grads_like.device)
