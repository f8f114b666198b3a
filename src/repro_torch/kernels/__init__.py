"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  Sources live in ``<family>/csrc/`` and are built by
``_build.py`` at first use."""
