"""PyTorch/CUDA port of the L-CSC reproduction, for one NVIDIA H100.

It stands beside the JAX package ``repro`` (the reference) and imports
nothing of it.  Public functions keep the JAX package's layouts and dtypes;
functions that take tensors run where their inputs live, and entry points
that create tensors default to ``device="cuda"``.
"""
