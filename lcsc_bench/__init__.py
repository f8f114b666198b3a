"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA
H100: LQCD solves and HPL, timed by the host clock, profiled by
``torch.profiler`` and weighed by nvidia-smi's power readings.

``python3 lcsc_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Everything a cell
needs is found by name: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``workloads/<cell>.json``,
``drivers/<driver>.py`` and ``metrics/<metric>.py``.
"""
