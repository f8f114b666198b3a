"""Hardware constants of the port's device, an NVIDIA H100 SXM, and of the
paper's GPU.

The H100 figures are NVIDIA's H100 Tensor Core GPU data sheet for the
SXM part (dense rates, no sparsity, at the full 700 W power limit), and
the DGX H100 data sheet for the link between nodes; they replace the TPU
constants of the JAX package's ``roofline/hw.py``.  A card set below
700 W runs slower under load: ``nvidia-smi --query-gpu=power.limit``
says which.  The watts the card draws are measured, not listed here: see
``repro_torch.power.model.H100_SXM``.
"""

# NVIDIA H100 SXM data sheet
PEAK_F32_FLOPS = 67e12         # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12       # bf16 on the tensor cores, dense
HBM_BW = 3.35e12               # bytes/s, HBM3
HBM_PER_CHIP = 80e9            # bytes (80 GB)
POWER_LIMIT_W = 700.0          # maximum board power
SM_COUNT = 132                 # streaming multiprocessors
# NVLink 4: the data sheet's 900 GB/s counts both directions; a chip
# sends at half that while it receives (the wire bytes of a collective)
NVLINK_BW = 450e9              # bytes/s per direction
# NVIDIA DGX H100 data sheet: eight ConnectX-7 400 Gb/s InfiniBand ports,
# one per GPU, the path between nodes (the roofline's cross-pod link)
DCN_BW = 50e9                  # bytes/s per GPU

# L-CSC reference constants, for the paper-reproduction models
S9150_PEAK_FP64 = 2.53e12
S9150_HBM_BW = 320e9
