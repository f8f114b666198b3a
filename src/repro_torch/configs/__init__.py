"""Configurations of the PyTorch/CUDA port."""
