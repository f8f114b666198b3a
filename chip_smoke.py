#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

  python3 chip_smoke.py

Phases (one line each, or a few):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels (four families, one nvcc each, in parallel)
     from the sources in this checkout; fail if ptxas reports spill bytes
     in any instantiation of the GEMM kernel or of the RMSNorm kernels;
  3. each kernel against its plain PyTorch version on the card, at the
     thermal lattice 32^3 x 8 (both even-odd source parities, and the full
     hop), rtol = atol = 1e-4; the fused Schur operator
     (``schur_eo_split``, inner None and bf16, dagger or not) against the
     plain hops and torch passes it replaced, bit for bit;
  4. the main path: ``solve_dirac(U, b, 0.137, EO_MIXED_SOLVER)`` at 32^3 x 8
     on seeded right-hand sides, with the kernels' launch counts read
     around it; then a small lattice solved on the CPU (plain versions) and
     on the card (kernels), which must agree;
  5. ``solve_dirac(..., PLAIN_SOLVER)`` at 32^3 x 8;
  6. each kernel's time (CUDA events) beside its bound and its plain
     version's time; B1's hop variants (load transform, epilogue) and
     the fused A^dagger A at 32^3 x 8 and 32^3 x 64 beside their bytes
     bounds and the unfused chain;
  7. the GEMM kernel (both entry points) against its plain version on the
     card: the JAX sweep's shapes in f32 and bf16 at its tolerances, a
     ragged shape, unaligned strided views, and HPL's step-0 trailing
     update at n = 32768 on views of one matrix, in f32;
  8. the second path: ``linpack_run(HPLConfig(n=32768, block=256,
     lookahead=1))``, which must pass HPL's residual check and launch the
     GEMM as often as n, block and lookahead imply; then one n = 1024
     matrix factored on the CPU (plain) and on the card (kernel), which
     must agree; then where the time goes: one factorization at n = 8192
     with and without torch.profiler (device time by kernel, the device's
     idle share);
  9. the step-0 update's time beside its bound, its plain version's and
     the library's (``addmm_``; ``torch.matmul`` of the product alone is
     printed too);
 10. the RMSNorm and SSD-chunk kernels against their plain versions on the
     card: the JAX sweeps' shapes at their tolerances, and the serve
     path's shapes (RMSNorm (8192, 1024) bf16 and (8192, 2048) f32 in
     prefill, (4, 1024) and (4, 2048) in decode, each with the kernel the
     library picks for it; one SSD chunk (4, 256, 32, 64, 128) with bf16
     x, B, C as views);
 11. the third path: serving mamba2-370m at its published widths
     (48 layers, seeded random weights): prefill of 4 x 2048 prompt tokens
     and 64 greedy decode steps through ``make_prefill_step``,
     ``grow_decode_cache`` and ``make_decode_step``, with exact launch
     counts (RMSNorm's by shape and by kernel variant too); then the
     model cut to 2 layers, prompt 300 (a ragged last chunk), on the CPU
     (plain versions) and on the card (kernels), which must pick the same
     greedy tokens over 8 steps;
 12. the new kernels' times beside their bounds, their plain versions'
     and the library's (``torch.nn.functional.rms_norm`` at RMSNorm's four
     path shapes, cold and warm, through ``kernels/rmsnorm/bench.py``;
     none computes an SSD chunk); the prefill's time and the
     decode rate; one prefill and 16 decode steps under torch.profiler
     (the device's busy share, its largest activities, the SSD-chunk and
     RMSNorm kernels' shares of the prefill's device time, its activities
     per decode step);
 13. energy: the card's watts (nvidia-smi's power.draw and SM clock every
     100 ms over 3 s) idle, under a loop of the thermal Schur normal op
     A^dagger A on the even-odd kernel (HBM-bound) and under a loop of
     HPL's step-0 update on the GEMM kernel (compute-bound), each beside
     the H100 table's constant; ``measured_lqcd_calibration`` at 32^3 x 8
     on the card; then ``cluster.run`` of the thermal EO_MIXED solve
     (``LQCDSolveWorkload`` with that calibration) and HPL at n = 32768
     (``HPLWorkload``) on the card, with exact launch counts and each
     result's joules held to its trace's integral; nvidia-smi samples the
     card's watts over that run;
 14. the T-sharded LQCD path, several shards on the one card (a
     ``lattice_mesh``): the sharded even-odd hop (B1 on halo-padded
     blocks) at 32^3 x 8 over 2 and 4 shards, both parities, equal bit
     for bit to the one-device hop, with one B1 launch per shard, and B1
     on one padded block against its plain version; ``dslash_sharded``
     (B2 on padded blocks) with and without compressed halos, equal to
     the one-device full hop; ``solve_dirac(..., EO_MIXED_SOLVER,
     mesh=lattice_mesh(64, 4))`` at 32^3 x 64 beside the one-device
     solve, and the same at 32^3 x 8 over 2 shards (converged, iterations
     within 2, x within 1e-3 of max|x|, B1 launches exact); at 32^3 x 64
     the sharded EO hop over 4 shards, both parities, equal bit for bit
     to the one-device hop, and B1 on shard 0's padded block, the
     one-device B1 and the one-device B2 against their plain versions,
     before those inputs are timed; the sharded
     hop's device time beside the one-device hop's; the calibration on
     4 shards beside the one-device one; a 8^3 x 16 sharded solve on the
     CPU (plain) against the card (B1);
 15. the autotuner on the card, and the GEMM's two tiles: the 64 x 128
     tile against the 128 x 128 tile bit for bit (the JAX sweep's shapes,
     ragged shapes and unaligned views, f32 and bf16, product and update;
     HPL's step-0 update at n = 32768) and against the plain version;
     each tile's time at the step-0 update and at (1024, 256) @ (256,
     1024), in turns, beside each shape's bound; then the autotuner's
     path with the launch counts read around it: the analytic and the
     measured (``MeasuredDgemmModel``) tile picks at both shapes,
     ``dgemm(..., tuned=True)`` at the small one, the HPL blocking search
     at n = 4096 timed on the card twice (``MeasuredHPLModel``, the
     fastest of 3 runs a point: each run's wall and residual, each
     point's GFLOP/s, each search's pick) beside the analytic pick, and
     ``HPLConfig(n=32768).tuned()``'s blocking (not run); and the plain
     version's and ``torch.matmul``'s times at the small product;
 16. the online simulator and trace replay on the card: (a)
     ``simulate(..., execute=True)`` of two HPL jobs at n = 4096 and three
     LQCD solves on the smoke lattice (phase 13's calibration) on two
     L-CSC nodes, with Weibull failures (seed 3 kills an HPL attempt) and
     Daly checkpoints: placements, records, outages, stats and the merged
     trace equal ``execute=False``'s bit for bit, every completed job has
     its result (HPL's residual passes, each solve converges), B1-B3
     launch as the results imply; (b) a seeded Poisson trace of 8
     requests (prompts 512 and 2048, generation 16 and 32) replayed
     through the continuous-batching engine with
     ``ExecutedGroupRuntime(mamba2-370m)`` at full width on the card:
     stats and trace equal the replay without the runtime, each request
     carries its tokens, B4 and B5 launch 97 per forward and 48 per chunk
     of each group's prefill, the first group's tokens equal the steps
     called directly, and phase 11's cut model gives the same tokens
     through the runtime on the card and on the CPU; each group's
     measured prefill and decode times beside the engine's analytic
     ones;
 17. the attention, MLP and MoE families: (a) llama3-8b at its published
     widths (32 layers, seeded random weights) served through
     ``launch.serve.generate``, 4 x 2048 prompt tokens and 64 greedy
     steps, B4 launched exactly 65 times per forward (65 at (8192, 4096),
     4160 at (4, 4096)), one decode step profiled; (b) the same with the
     int8 KV cache: its greedy tokens against (a)'s, the cosine of its
     last logits on (a)'s contexts (held > 0.99, the JAX package's int8
     criterion), the caches' bytes beside ``kv_cache_bytes``; (c) its
     first 2 layers at full width, 16 prompts of 300 tokens on the CPU
     (plain versions) and on the card (kernels): logits within 2e-2 of
     the largest, the row whose CPU top-2 gap is widest greedy-equal over
     8 steps; (d) ``ExecutedGroupRuntime("llama3-8b", smoke=False)`` on
     one group against the steps called directly; hymba-1.5b (1 x 3072,
     past its window: B5 at N = 16), whisper-small (4 x 448),
     llava-next-mistral-7b (576 patches + 512 tokens) at full width and
     grok-1-314b and deepseek-v2-236b cut to 2 layers at full width (4 x
     512), each with 8 decode steps and B4/B5 launched as its structure
     says; every architecture's smoke config on the CPU and the card
     (bf16 logits within 2e-2, f32 greedy tokens equal); (e) B4 at the
     new path shapes (llama3-8b's, hymba's) cold and warm beside
     ``F.rms_norm`` and B5 at hymba's chunk, beside their bounds;
 18. the train step (``make_train_step``; B4 and B5 forward through
     their autograd.Functions, whose backward is autograd of the plain
     versions): (a) mamba2-370m at its published widths (48 layers,
     seeded random weights, bf16, f32 AdamW moments), remat "layer", 2
     microbatches of 2 x 2048, 6 steps on one synthetic batch: finite
     losses falling by more than 0.5, B4 and B5 launched exactly 386 and
     1536 times a step (each layer forward, then again in backward's
     recompute), the step's wall and tokens/s, peak memory beside
     ``estimate_train_bytes``; one step profiled (busy share, largest
     activities, B4's, B5's and the plain backwards' shares); (b) its
     first 2 layers at full width, 2 x 512, float32 and bfloat16, on the
     CPU (plain versions) and the card (kernels): gradients within 1e-3
     / 2e-2 of each leaf's max|g| (the AdamW moments after step 2 too),
     the losses within 1e-4 / 2e-2, and the parameters after step 2
     (where lr > 0) within 1e-6 (bf16: one ulp more) of the difference
     the two devices' moments imply through Adam's step; (c) llama3-8b
     cut to 2 layers at full width, 2 x 2048, remat "layer" and
     "block", 6 steps at lr 3e-5: losses
     within 1e-3 of each other, finite and falling, B4 exact, peak
     memory beside the estimate; (d) every smoke config's loss,
     gradients and step on the CPU and the card (f32: the loss within
     1e-4, each gradient leaf within 1e-3 of its largest value); (e) B4
     at the train shapes cold and warm beside ``F.rms_norm``, B5 at the
     microbatch's chunk, and the plain SSD backward, timed beside their
     bounds;
 19. the training driver (``python -m repro_torch.launch.train`` through
     its ``main``): (a) mamba2-370m at its published widths, 4 x 2048, 6
     steps under the driver's remat "none", a checkpoint every 2 steps
     into a temporary directory the phase deletes: each step's loss and
     wall, B4 and B5 launched a step exactly as the structure says, peak
     memory beside ``estimate_train_bytes``, the blocking time of each
     ``save()`` and of the final ``wait()``, the bytes written, the
     driver's ``[energy]`` lines beside nvidia-smi's mean draw over the
     run, and the newest checkpoint restored into a fresh model bit-equal
     to the parameters at that step; (b) the fault path on its 2-layer
     cut: non-finite losses injected by a wrapper of the step at steps 0
     (before any checkpoint), 3 and, past the 2 retries, 5 and 6: after
     each rollback the parameters and AdamW state bit-equal to the last
     checkpointed step's (or to the state before the step), the bad step
     kept past the retries, the rollback count as the reference's rule
     says; (c) the driver on the olmo-1b and mamba2-370m smoke configs at
     float32, 6 steps on the CPU and on the card from the same weights:
     losses and checkpoint leaves within [18d]'s tolerances; (d) the five
     examples (``examples/torch_*.py``) on the card.
 20. the sharded LM path on one controller, a (2, 2) ``LMMesh`` whose
     four coordinates sit on the card: (a) hymba-1.5b at its published
     widths, 2 x 4096 prompt tokens and 16 greedy steps on the mesh
     (every attention layer sequence-sharded: 25 heads on a model axis
     of 2) against ``mesh=None``: B4/B5 launches equal, the K/V
     all-gathers' bytes what the shapes imply, every step's logits within
     LM_TOL and the argmax equal wherever the top-2 gap is wider than
     twice the step's largest difference; (b) its sharded train step (4 x
     2048, 2 microbatches, remat "layer", 3 steps) against the one-device
     step: launches equal and the structure's, losses within
     SHARD_LOSS_TOL; then the shards saved and restored onto (1, 4) and
     (1, 1) meshes, every shard bit-equal; (c) grok-1-314b cut to 2
     layers at full width, 2 x 2048 through the "expert" plan and 4
     serve-EP decode steps: walls, peaks, token slots dropped per
     coordinate and the logits' distance from ``mesh=None``, reported;
     (d) the qwen, grok and deepseek smoke configs' sharded prefill,
     decode and train step on the CPU and the card.
 21. the multi-pod dry run (``python -m repro_torch.launch.dryrun``
     through its ``main``) on ``meta`` tensors: (a) llama3-8b
     decode_32k on the 256- and the 512-coordinate production meshes and
     mamba2-370m train_4k on the 256-coordinate one, at full width, into
     a temporary directory the phase deletes: each record ok, its
     roofline ``cost_for`` of its plan at the H100's rates, the table of
     ``roofline.report``, plan and trace seconds; (b) llama3-8b decode
     and mamba2-370m train (4 x 2048, the plan ``plan_cell`` picks)
     traced on a one-device mesh and run on the card from the same
     shapes: B4/B5 launches equal to the trace's calls, the card's peak
     memory within DRYRUN_PEAK_TOL of ``total_hbm_bytes``, the walls
     beside ``step_lower_bound_s``.
Every time is taken by ``repro_torch.kernels.timing``: the calls are
queued behind a sleep kernel, and a kernel's or a library call's reading
that the host paced is taken again behind a longer sleep (a plain
version's is kept, the host's pace in it).  The line before the last is the
kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises: the script then
exits non-zero and prints no result.  It needs a CUDA device and the
``src/repro_torch`` package beside it.
"""
from __future__ import annotations

import copy
import json
import math
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

KAPPA = 0.137
SEED = 0
N_RHS = 2
TOL = 1e-4                      # rtol = atol: tests/test_kernels.py sweep
SOURCE = "src/repro_torch/kernels/dslash/csrc/dslash.cu"
REPLACES = {"dslash_eo_split": "src/repro/kernels/dslash/kernel.py:180",
            "dslash_split": "src/repro/kernels/dslash/kernel.py:217",
            "dslash_eo_fused": "src/repro/lqcd/eo.py:166"}
GEMM_SOURCE = "src/repro_torch/kernels/dgemm/csrc/dgemm.cu"
GEMM_REPLACES = "src/repro/kernels/dgemm/kernel.py:30"
PANEL_SOURCE = "src/repro_torch/kernels/panel/csrc/panel.cu"
# phase 8b: the panel kernel against the plain panel at HPL's shapes, max
# |dlu| over max|lu|; rounding alone stays far below it, a wrong swap or
# update far above
PANEL_NORMWISE = 1e-4
# tests/test_kernels.py::test_dgemm_sweep: shapes (m, n, k), tolerances
GEMM_SWEEP = [(128, 128, 128), (256, 128, 384), (512, 256, 128)]
GEMM_RAGGED = (1000, 333, 259)
HPL_N, HPL_NB, HPL_LOOKAHEAD = 32768, 256, 1
SMALL_HPL_SEED = 20             # see phase 8
SMALL_GEMM = (1024, 1024, 256)  # (m, n, k) of phase 15's small product
HPL_TUNE_N = 4096               # phase 15's measured HPL blocking search
HPL_TUNE_SEARCHES = 2           # ... run this many times, 3 runs a point
HPL_PROFILE_N = 8192
RMS_SOURCE = "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu"
RMS_REPLACES = "src/repro/kernels/rmsnorm/kernel.py:23"
SSD_SOURCE = "src/repro_torch/kernels/ssd_chunk/csrc/ssd_chunk.cu"
SSD_REPLACES = "src/repro/kernels/ssd_chunk/kernel.py:43"
# tests/test_kernels.py::test_rmsnorm_sweep and
# tests/test_kernels_extra.py::test_ssd_chunk_sweep
RMS_SWEEP = [(64, 128), (256, 512), (132, 256)]
SSD_SWEEP = [(2, 16, 3, 8, 4), (1, 32, 2, 16, 8), (3, 8, 4, 4, 16)]
ARCH = "mamba2-370m"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 64
CUT_LAYERS, CUT_PROMPT, CUT_STEPS = 2, 300, 8
CUT_SEED = 37                   # see phase 11
# measured 0.0156 (one bf16 ulp at the logits' size, max|logit| 4.06) on
# an NVIDIA H100 80GB HBM3; held at two ulps of the largest logit
CUT_LOGIT_TOL = 0.0625
PROFILE_DECODE_STEPS = 16
SIM_HPL_N, SIM_HPL_NB = 4096, 256      # phase 16a's HPL jobs
SIM_MTBF_S, SIM_REPAIR_S = 1000.0, 300.0
SIM_SEED = 3                    # its failure draws: kills one HPL attempt
REPLAY_N, REPLAY_BATCH = 8, 4   # phase 16b's requests, the engine's slots
REPLAY_PROMPTS, REPLAY_GENS = (512, 2048), (16, 32)
REPLAY_SEED = 0                 # arrivals at 4x capacity: a 3-request group
WATT_LEAD_S, WATT_WINDOW_S = 1.0, 3.0   # see phase 13
# phase 17: the attention, MLP and MoE families
LLAMA = "llama3-8b"
INT8_COSINE = 0.99    # tests/test_attention_ssm.py::test_int8_kv_cache_quality
LM_TOL = dict(rtol=2e-2, atol=2e-2)     # the JAX package's bf16 serve tol.
CUT_CANDIDATES = 16   # phase 17c's prompts; the CPU's widest top-2 gap is held
# (arch, layers (None: all), batch, prompt): phase 17d's full-width runs
FAMILY_RUNS = [("hymba-1.5b", None, 1, 3072), ("whisper-small", None, 4, 448),
               ("llava-next-mistral-7b", None, 1, 512),
               ("grok-1-314b", 2, 4, 512), ("deepseek-v2-236b", 2, 4, 512)]
FAMILY_STEPS = 8
SMOKE_PROMPT = 45     # the smoke configs' CPU-card runs (past hymba's window)
RUNTIME_GROUP = (512, 16, 2)    # phase 17d's runtime group: prompt, steps, n
# phase 18: the train step
TRAIN_TC = dict(remat="layer", microbatches=2, warmup_steps=1,
                learning_rate=3e-3)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 6
TRAIN_LOSS_DROP = 0.5     # [18a]: the last loss below the first by this
TRAIN_CUT = (2, 2, 512)   # [18b]: layers, batch, sequence, CPU vs card
LLAMA_TRAIN = (2, 2, 2048)  # [18c]: llama3-8b's layers, batch, sequence
# [18c]'s rate and steps: Adam's first step moves every weight by lr
# whatever its gradient, so each of the 128256 logits moves by up to lr
# times sum|h| (~0.8 d, d = 4096): on an H100 its loss went from 12.48
# to 23.34 at lr 3e-3 and to 13.41 at 3e-4; at 3e-5 the first-order fall
# outweighs that spread
LLAMA_TRAIN_LR, LLAMA_TRAIN_STEPS = 3e-5, 6
TRAIN_SMOKE = (2, 45)     # [18d]: every smoke config's batch, sequence
# [18b]/[18d] CPU against card: each gradient leaf within this share of
# its largest |g| (float32: B5's own f32 sums, held at 1e-5 of max|y| a
# chunk, put mamba2's A_log gradient, a sum over every position, 1.2e-4
# of its largest value apart on an H100); [18b] the parameters after
# step 2 within TRAIN_P_TOL (bf16: one ulp more) of what the two
# devices' AdamW moments imply (compare_train)
TRAIN_GRAD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
TRAIN_LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # relative
TRAIN_P_TOL = 1e-6
# phase 19: the training driver, launch.train
DRIVER_BATCH, DRIVER_SEQ, DRIVER_STEPS, DRIVER_EVERY = 4, 2048, 6, 2
FAULT_RUN = (2, 2, 512, 8)     # [19b]: layers, batch, sequence, steps
# [19b]'s steps whose loss is made non-finite: step 0 before any
# checkpoint (undone), step 3 after one (back to step 2's), steps 5 and 6
# past FaultPolicy's 2 retries (kept)
FAULT_BAD = (0, 3, 5, 6)
DRIVER_SMOKE = (("olmo-1b", "mamba2-370m"), 2, 45, 6)   # [19c]
# phase 20: the sharded LM path on one controller
SHARD_ARCH, SHARD_MESH = "hymba-1.5b", (2, 2)
SHARD_SERVE = (2, 4096, 16)     # [20a]: batch, prompt, greedy steps
SHARD_TRAIN = (4, 2048, 3)      # [20b]: batch, sequence, steps
SHARD_TC = dict(remat="layer", microbatches=2, warmup_steps=1,
                learning_rate=1e-4)
# [20b]: the sharded step's losses within this share of the one-device
# step's (TRAIN_LOSS_TOL's bfloat16 figure)
SHARD_LOSS_TOL = 2e-2
# [20c]: grok-1-314b's layers, batch, prompt, decode steps; the batch is
# 2, not 1: the data axis of 2 splits it, as the reference's shard_map
SHARD_GROK = (2, 2, 2048, 4)
# [20d]: float32 smoke configs on the CPU and the card: logits within
# this rtol and this share of the largest |logit|, losses relative
SHARD_SMOKE = (("qwen1.5-32b", "grok-1-314b", "deepseek-v2-236b"), 4, 64)
SHARD_SMOKE_TOL = 1e-4
# phase 21: the dry run.  [21a]: (arch, shape, meshes) through the CLI on
# the production meshes (pod1: 16 x 16, pod2: 2 x 16 x 16).  deepseek-v2's
# prefill_32k on pod2 traces in ~100 s on a CPU, past the phase's limit
DRYRUN_CELLS = (("llama3-8b", "decode_32k", ("pod1", "pod2")),
                ("mamba2-370m", "train_4k", ("pod1",)))
# [21b]: (arch, sequence, batch, kind) traced on a one-device mesh and run
# on the card from the same shapes; the card's peak within this share of
# the trace's total_hbm_bytes
DRYRUN_CARD = (("llama3-8b", 2048, 4, "decode"),
               ("mamba2-370m", 2048, 4, "train"))
DRYRUN_PEAK_TOL = 0.25
EXAMPLES = ("torch_quickstart", "torch_lqcd_cg",
            "torch_green500_measurement", "torch_autotune_sweep",
            "torch_efficient_serving")
WATT_QUERY = ["nvidia-smi", "--query-gpu=power.draw,clocks.sm",
              "--format=csv,noheader,nounits", "-lms", "100"]


def own_launches(counts: dict, name: str) -> int:
    """A kernel record's launches in ``counts``: B1's plain record
    ("dslash_eo_split") takes the hops that the fused Schur operator
    ("dslash_eo_fused", a record of its own) did not make."""
    n = counts.get(name, 0)
    return n - counts.get("dslash_eo_fused", 0) if name == "dslash_eo_split" \
        else n


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def device_activity(fn, ops: tuple = ()):
    """Run ``fn()`` under torch.profiler; return its result, the wall
    seconds (host clock, synchronised), the device seconds and count of
    each device activity by name, and the names in the order they ran.
    With ``ops`` (names of host-side events, such as an autograd node's
    ``<Function>Backward``), a sixth item: for each, the device seconds
    of the work its events launched (children included), their count
    and the device activities they launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, count = {}, {}
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    for e in device:
        busy[e.name] = busy.get(e.name, 0.0) + e.device_time_total / 1e6
        count[e.name] = count.get(e.name, 0) + 1
    order = [e.name for e in sorted(device, key=lambda e: e.time_range.start)]
    if not ops:
        return out, wall, busy, count, order
    def launched(e) -> int:
        return len(e.kernels) + sum(launched(c) for c in e.cpu_children)

    op_busy = {op: [0.0, 0, 0] for op in ops}
    for e in events:
        if e.name in op_busy:
            op_busy[e.name][0] += e.device_time_total / 1e6
            op_busy[e.name][1] += 1
            op_busy[e.name][2] += launched(e)
    return out, wall, busy, count, order, op_busy


def hpl_profile(blocked_lu, a) -> None:
    """Factor ``a`` once plain and once under torch.profiler; print the
    wall times, the device's busy time by kernel and its idle share."""
    import torch
    n = a.shape[0]

    def factor() -> None:
        blocked_lu(a, HPL_NB, lookahead=HPL_LOOKAHEAD)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    factor()
    torch.cuda.synchronize()
    plain = time.perf_counter() - t0
    _, wall, busy, count, _ = device_activity(factor)
    gemm = [0.0, 0]
    for name in [k for k in busy if "gemm_kernel" in k]:
        gemm[0] += busy.pop(name)
        gemm[1] += count.pop(name)
    total = sum(busy.values()) + gemm[0]
    print(f"[8] where the time goes, blocked_lu at n={n}, nb={HPL_NB}: "
          f"{plain:.3f} s plain, {wall:.3f} s under the profiler; "
          f"device busy {total:.3f} s ({100 * total / wall:.1f}% of the "
          f"profiled wall, idle {100 - 100 * total / wall:.1f}%): the "
          f"GEMM kernel {gemm[0]:.4f} s in {gemm[1]} launches, the rest "
          f"{total - gemm[0]:.4f} s in {sum(count.values())} device "
          f"activities ({sum(count.values()) / n:.1f} per column); the "
          f"largest of those:")
    for name in sorted(busy, key=busy.get, reverse=True)[:5]:
        print(f"    {busy[name]:.4f} s in {count[name]} x {name[:90]}")


def print_activity(what: str, wall: float, busy: dict, count: dict,
                   steps: int = 0, tag: str = "[12]") -> None:
    total, n = sum(busy.values()), sum(count.values())
    per = f", {n / steps:.1f} per step" if steps else ""
    print(f"{tag} profiled {what}: {wall * 1e3:.2f} ms wall, device busy "
          f"{total * 1e3:.2f} ms ({100 * total / wall:.1f}%, idle "
          f"{100 - 100 * total / wall:.1f}%) in {n} device activities{per}; "
          f"the largest:")
    for name in sorted(busy, key=busy.get, reverse=True)[:5]:
        print(f"    {busy[name] * 1e3:.3f} ms in {count[name]} x "
              f"{name[:90]}")


class PowerSamples:
    """``nvidia-smi`` sampling power.draw and the SM clock every 100 ms
    for as long as the ``with`` block runs; ``watts`` and ``clocks`` hold
    the samples afterwards.  A sampler that ends early or prints anything
    else fails the run."""

    def __enter__(self) -> "PowerSamples":
        self.smi = subprocess.Popen(WATT_QUERY, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc) -> None:
        alive = self.smi.poll() is None
        # SIGINT, as a Ctrl-C ends nvidia-smi's loop: it flushes its output
        self.smi.send_signal(signal.SIGINT)
        try:
            out, err = self.smi.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.smi.kill()
            out, err = self.smi.communicate(timeout=30)
        if exc[0] is not None:
            return
        check(alive, f"nvidia-smi sampled the whole window (exit "
                     f"{self.smi.returncode}: {err[:200]!r})")
        rows = [line.split(",") for line in out.strip().splitlines()]
        check(len(rows) >= 10 and all(len(r) == 2 for r in rows),
              f"nvidia-smi gave power.draw, clocks.sm samples: {out[:200]!r} "
              f"{err[:200]!r}")
        self.watts = [float(r[0]) for r in rows]
        self.clocks = [float(r[1]) for r in rows]

    @property
    def mean_w(self) -> float:
        return sum(self.watts) / len(self.watts)


def read_watts(fn=None) -> tuple[float, int, float, float]:
    """Run ``fn()`` in a loop (or leave the card idle) for WATT_LEAD_S,
    then for WATT_WINDOW_S more with ``nvidia-smi`` sampling beside it.
    Returns the mean watts, the sample count, the mean SM clock (MHz) and
    the calls per second in the window.  The host keeps at most two
    batches of 8 calls queued ahead of the card, so the card never drains
    between them."""
    import torch

    def loop(seconds: float) -> int:
        t0, n, marks = time.perf_counter(), 0, []
        while time.perf_counter() - t0 < seconds:
            if fn is None:
                time.sleep(0.01)
                continue
            fn()
            n += 1
            if n % 8 == 0:
                marks.append(torch.cuda.Event())
                marks[-1].record()
                if len(marks) > 2:
                    marks.pop(0).synchronize()
        return n

    torch.cuda.synchronize()
    loop(WATT_LEAD_S)
    with PowerSamples() as ps:
        t0 = time.perf_counter()
        rate = loop(WATT_WINDOW_S) / (time.perf_counter() - t0)
    torch.cuda.synchronize()
    return ps.mean_w, len(ps.watts), sum(ps.clocks) / len(ps.clocks), rate


def rmsnorms_per_forward(cfg) -> int:
    """B4 launches one forward makes, from the model's structure: each
    layer's RMSNorm-variant norms (norm1, norm_x, norm2), the SSM's gated
    norm, MLA's q_norm and kv_norm, the encoder's norms and the final
    one."""
    rms = cfg.norm_variant == "rmsnorm"
    per = rms * (1 + (cfg.family == "encdec")
                 + (cfg.family == "moe" or cfg.d_ff > 0))
    per += cfg.family in ("ssm", "hybrid")
    if cfg.mla.enabled:
        per += 1 + bool(cfg.mla.q_lora_rank)
    enc = (2 * cfg.n_encoder_layers + 1) * rms \
        if cfg.family == "encdec" else 0
    return per * cfg.n_layers + rms + enc


def ssd_chunks_per_prefill(cfg, seq: int) -> int:
    """B5 launches of one prefill of ``seq`` positions."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0
    return cfg.n_layers * -(-seq // cfg.ssm.chunk_size)


def greedy_run(cfg, params, batch: dict, steps: int, kv_int8: bool = False,
               feed=None):
    """Prefill ``batch``, then ``steps`` decode steps through the serve
    path's steps.  Each step's token is the argmax of the previous logits
    or, with ``feed`` (B, steps), fed.  Returns the steps + 1 logits (the
    vocab tail cut, float32 on the CPU) and the tokens decoded (B,
    steps)."""
    import torch
    from repro_torch.runtime.steps import (grow_decode_cache,
                                           make_decode_step,
                                           make_prefill_step)
    V = cfg.vocab_size
    logits, cache = make_prefill_step(cfg, quantize_kv_cache=kv_int8)(
        params, batch)
    B, S = batch["tokens"].shape
    total = S + steps + (cfg.n_patches if cfg.family == "vlm" else 0)
    cache = grow_decode_cache(cfg, cache, B, total, quantize_kv_cache=kv_int8)
    decode = make_decode_step(cfg)
    out, toks = [logits[:, :V].float().cpu()], []
    for i in range(steps):
        tok = (feed[:, i:i + 1] if feed is not None
               else torch.argmax(logits[:, :V], -1)[:, None])
        toks.append(tok.cpu())
        logits, cache = decode(params, tok.to(logits.device, torch.int32),
                               cache)
        out.append(logits[:, :V].float().cpu())
    return out, torch.cat(toks, 1)


def top2_gap(logits) -> "torch.Tensor":
    import torch
    top = torch.topk(logits, 2, -1).values
    return top[:, 0] - top[:, 1]


def cpu_card_forced(cfg, p_cpu, p_gpu, batch: dict, steps: int, dev):
    """The model on the CPU (plain versions), greedy; on the card (the
    kernels) fed the CPU's tokens, so both see the same contexts.  Every
    step's logits are held within LM_TOL; returns max|dlogits|, the share
    of steps whose argmax agrees and the narrowest CPU top-2 gap."""
    import torch
    cpu, toks = greedy_run(cfg, p_cpu, batch, steps)
    card, _ = greedy_run(cfg, p_gpu, {k: v.to(dev) for k, v in
                                      batch.items()}, steps, feed=toks)
    for a, b in zip(card, cpu):
        torch.testing.assert_close(a, b, **LM_TOL)
    d = max(float((a - b).abs().max()) for a, b in zip(card, cpu))
    agree = torch.stack([torch.argmax(a, -1) == torch.argmax(b, -1)
                         for a, b in zip(card, cpu)])
    gap = min(float(top2_gap(b).min()) for b in cpu)
    return d, float(agree.float().mean()), gap


def phase17(dev, card: str, records: list) -> float:
    """[17] The attention, MLP and MoE families on the card: llama3-8b at
    full width through the serve path (bf16 and int8 caches), its 2-layer
    cut on the CPU and the card, the other families at full width (MoE
    cut to 2 layers), every smoke config on the CPU and the card, and the
    executed runtime; B4 at the new path shapes and B5 at hymba's chunk
    timed beside their bounds.  Returns the phase's seconds."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.config import full_config, smoke_config, ARCH_IDS
    from repro_torch.kernels.rmsnorm import bench as RB
    from repro_torch.kernels.rmsnorm import kernel as RK
    from repro_torch.kernels.ssd_chunk import kernel as SK
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
    from repro_torch.kernels.timing import bound, timed_ms
    from repro_torch.launch.serve import generate, make_batch
    from repro_torch.models import init_params
    from repro_torch.models.transformer import Model, kv_cache_bytes
    from repro_torch.roofline import hw
    from repro_torch.runtime.steps import (grow_decode_cache,
                                           make_decode_step,
                                           make_prefill_step)
    from repro_torch.serve import ExecutedGroupRuntime

    t17 = time.perf_counter()
    torch.cuda.empty_cache()
    rec = {r["name"]: r for r in records}
    path_launches = {}              # run -> {kernel: launches}
    path_shapes = {}                # run -> {(rows, d, x dtype): launches}

    def counted(what, fn):
        """fn() with B4 and B5 counted from 0; returns fn's result."""
        RK.reset_launches()
        SK.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        path_launches[what] = {"rmsnorm": RK.LAUNCHES["rmsnorm"],
                               "ssd_chunk": SK.LAUNCHES["ssd_chunk"]}
        path_shapes[what] = dict(RK.SHAPE_LAUNCHES)
        return out

    def cache_bytes(cache):
        return sum(t.numel() * t.element_size() for k, t in cache.items()
                   if k != "pos")

    # 17a. llama3-8b at its published widths through the serve path
    cfg = full_config(LLAMA)
    V, L = cfg.vocab_size, cfg.n_layers
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[17a] {cfg.name}: {L} layers, d_model {cfg.d_model}, GQA "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.d_head}, d_ff {cfg.d_ff},"
          f" vocab {V}, {cfg.dtype}; {n_params} parameter elements "
          f"({n_params * 2 / 1e9:.2f} GB; param_count() "
          f"{cfg.param_count()} leaves out the final norm's "
          f"{cfg.d_model}), initialised in {time.perf_counter() - t0:.2f} s")
    check(n_params == cfg.param_count() + cfg.d_model,
          "llama3-8b's parameters are its configuration's")
    batch = make_batch(cfg, SERVE_BATCH, SERVE_PROMPT, dev)
    per_fwd = rmsnorms_per_forward(cfg)
    generate(cfg, params, batch, 2)        # warm-up: cuBLAS, the allocator
    runs = {}
    for kv_int8 in (False, True):
        what = "llama3_8b" + ("_int8" if kv_int8 else "")
        run = counted(what, lambda: generate(cfg, params, batch, SERVE_GEN,
                                             kv_int8=kv_int8))
        runs[kv_int8] = run
        n = path_launches[what]["rmsnorm"]
        toks = run.tokens
        print(f"[17{'b' if kv_int8 else 'a'}] served {SERVE_BATCH} x "
              f"{SERVE_PROMPT} prompt tokens then {SERVE_GEN} greedy steps"
              f"{' with the int8 KV cache' if kv_int8 else ''} "
              f"(launch.serve.generate): prefill {run.prefill_s * 1e3:.1f} "
              f"ms ({SERVE_BATCH * SERVE_PROMPT / run.prefill_s:.0f} tok/s),"
              f" decode {run.decode_s / SERVE_GEN * 1e3:.2f} ms per step "
              f"({SERVE_GEN * SERVE_BATCH / run.decode_s:.1f} tok/s); the "
              f"weights' {n_params * 2 / 1e9:.2f} GB read once a step take "
              f"{n_params * 2 / hw.HBM_BW * 1e3:.2f} ms at "
              f"{hw.HBM_BW / 1e12:.2f} TB/s; B4 {n} launches ({per_fwd} "
              f"per forward), B5 {path_launches[what]['ssd_chunk']}; "
              f"sample {toks[0, :8].tolist()} ({card})")
        check(bool(torch.isfinite(run.logits).all())
              and bool((toks < V).all()) and toks.shape == (SERVE_BATCH,
                                                            SERVE_GEN),
              "llama3-8b's logits are finite and its tokens in the vocab")
        check(int(run.cache["pos"]) == SERVE_PROMPT + SERVE_GEN,
              "the cache's position advanced once a step")
        check(n == per_fwd * (1 + SERVE_GEN) == 65 * (1 + SERVE_GEN)
              and path_launches[what]["ssd_chunk"] == 0,
              "B4 launched 65 times per forward, B5 never")
    check(path_shapes["llama3_8b"] == {(SERVE_BATCH * SERVE_PROMPT, cfg.d_model,
                        torch.bfloat16): per_fwd,
                       (SERVE_BATCH, cfg.d_model, torch.bfloat16):
                       per_fwd * SERVE_GEN},
          "B4 ran 65 times at (8192, 4096) and 4160 at (4, 4096)")
    a, b = runs[False], runs[True]
    agree = float((a.tokens == b.tokens).float().mean())
    first = [int((a.tokens[r] != b.tokens[r]).nonzero()[0])
             if (a.tokens[r] != b.tokens[r]).any() else SERVE_GEN
             for r in range(SERVE_BATCH)]
    # the int8 cache against the bf16 cache on the same contexts: the
    # bf16 run's tokens fed to the int8 cache's decode
    forced, _ = greedy_run(cfg, params, batch, SERVE_GEN, kv_int8=True,
                           feed=a.tokens)
    x, y = a.logits[:, :V].float().cpu(), forced[-1]
    cos = float((x * y).sum() / (x.norm() * y.norm()))
    want_bytes = kv_cache_bytes(cfg, SERVE_BATCH, SERVE_PROMPT + SERVE_GEN)
    print(f"[17b] int8 KV cache: greedy tokens {100 * agree:.1f}% equal to "
          f"the bf16 cache's (first difference per row at step {first}); "
          f"fed the bf16 run's tokens, the last step's logits have cosine "
          f"{cos:.6f} to the bf16 cache's (held > {INT8_COSINE}); cache "
          f"bytes: kv_cache_bytes() {want_bytes}, the bf16 cache's k and v "
          f"{cache_bytes(a.cache)} allocated, the int8 cache's k, v, k_s, "
          f"v_s {cache_bytes(b.cache)} ({card})")
    check(cos > INT8_COSINE, f"int8 cache logits cosine > {INT8_COSINE}")
    check(cache_bytes(a.cache) == want_bytes
          and cache_bytes(b.cache) == want_bytes // 2 + 2 * 4 * L
          * SERVE_BATCH * (SERVE_PROMPT + SERVE_GEN),
          "the caches hold the bytes kv_cache_bytes() says (int8: half, "
          "plus the f32 scales)")
    cache = grow_decode_cache(cfg, a.cache, SERVE_BATCH,
                              SERVE_PROMPT + SERVE_GEN + 1)
    decode = make_decode_step(cfg)
    tok = a.tokens[:, -1:].to(torch.int32)
    _, wall, busy, count, _ = device_activity(
        lambda: decode(params, tok, cache))
    print_activity("one llama3-8b decode step (batch 4, 2112 cached "
                   "positions)", wall, busy, count, steps=1, tag="[17a]")
    # what forward_decode's copy of the attention caches costs a step
    kv = {k: cache[k] for k in ("k", "v")}
    copy_ms = timed_ms(lambda: {k: t.clone() for k, t in kv.items()},
                       reps=10, warmup=2)
    kv_b = cache_bytes(kv)
    print(f"[17a] the decode step's copy of the K/V caches ({kv_b} bytes, "
          f"read and written): {copy_ms:.3f} ms "
          f"({2 * kv_b / copy_ms / 1e6:.0f} GB/s; "
          f"{2 * kv_b / hw.HBM_BW * 1e3:.3f} ms at {hw.HBM_BW / 1e12:.2f} "
          f"TB/s) ({card})")
    del runs, a, b, cache, forced

    # 17c. the model cut to 2 layers at full width: CPU against card.
    # CUT_CANDIDATES prompts run on the CPU; the one whose narrowest top-2
    # gap is widest is held token for token (as phase 11 chose its seed)
    cut = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    p_gpu = Model(params.embed, params.layers[:CUT_LAYERS],
                  params.final_norm, params.lm_head)
    p_cpu = copy.deepcopy(p_gpu).to("cpu")
    prompts = torch.from_numpy(np.random.default_rng(CUT_SEED).integers(
        0, V, (CUT_CANDIDATES, CUT_PROMPT)))
    cpu, toks_c = greedy_run(cut, p_cpu, {"tokens": prompts}, CUT_STEPS)
    gaps = torch.stack([top2_gap(x) for x in cpu]).min(0).values
    row = int(torch.argmax(gaps))
    card_l, toks_g = counted("llama3_8b_cut", lambda: greedy_run(
        cut, p_gpu, {"tokens": prompts.to(dev)}, CUT_STEPS))
    # the JAX package's bf16 tolerance taken relative to the largest
    # logit: elementwise rtol = atol = 2e-2 does not hold at full width,
    # where 0.3% of the 128256 logits a row sit up to 0.054 off (1.7 bf16
    # ulps at the logits' size) on an H100, with the plain RMSNorm on the
    # card as with B4 (the products differ: cuBLAS against the CPU's)
    big = float(cpu[0].abs().max())
    tol = LM_TOL["rtol"] * big
    d_pre = float((card_l[0] - cpu[0]).abs().max())
    within = float(((card_l[0] - cpu[0]).abs()
                    <= LM_TOL["atol"] + LM_TOL["rtol"]
                    * cpu[0].abs()).float().mean())
    same = torch.equal(toks_c[row], toks_g[row])
    d_row = max(float((a[row] - b[row]).abs().max())
                for a, b in zip(card_l, cpu))
    print(f"[17c] {cut.n_layers} layers at full width, prompts "
          f"{CUT_CANDIDATES} x {CUT_PROMPT}: CPU plain vs card kernels, "
          f"prefill max|dlogits| {d_pre:.4f} (max|logit| {big:.3f}; held "
          f"within 2e-2 of it, {tol:.4f}; "
          f"{100 * within:.2f}% within rtol = atol = 2e-2); row {row} (the "
          f"CPU's widest narrowest top-2 gap, {float(gaps[row]):.4f}; the "
          f"others {[round(float(g), 4) for g in gaps]}): tokens "
          f"{toks_c[row].tolist()} (CPU), {toks_g[row].tolist()} (card), "
          f"its decode max|dlogits| {d_row:.4f}; all rows' tokens equal: "
          f"{torch.equal(toks_c, toks_g)}; card launches "
          f"{path_launches['llama3_8b_cut']}")
    check(d_pre <= tol, f"prefill logits agree within {tol}")
    check(same, "the held row's greedy tokens are equal on CPU and card")
    check(d_row <= tol, f"the held row's logits agree within {tol} at "
          f"every step")
    check(path_launches["llama3_8b_cut"]["rmsnorm"]
          == rmsnorms_per_forward(cut) * (1 + CUT_STEPS),
          "the cut model on the card went through B4")
    del p_cpu, p_gpu, cpu, card_l

    # 17d. the executed runtime serves a group of llama3-8b at full width
    s0, g0, n0 = RUNTIME_GROUP
    rt = ExecutedGroupRuntime(LLAMA, smoke=False, params=params,
                              seed=REPLAY_SEED, device="cuda")
    got = counted("runtime_llama3_8b", lambda: rt.run_group(s0, g0, n0))
    prompt0 = torch.from_numpy(np.random.default_rng(REPLAY_SEED).integers(
        0, V, (n0, s0))).to(dev, torch.int32)
    logits, cache = make_prefill_step(cfg)(params, {"tokens": prompt0})
    cache = grow_decode_cache(cfg, cache, n0, s0 + g0)
    direct = [torch.argmax(logits[:, :V], -1)[:, None].to(torch.int32)]
    for _ in range(g0 - 1):
        logits, cache = decode(params, direct[-1], cache)
        direct.append(torch.argmax(logits[:, :V], -1)[:, None]
                      .to(torch.int32))
    direct = torch.cat(direct, 1).cpu().numpy()
    pre_s, dec_s = rt.groups[0][3:]
    print(f"[17d] ExecutedGroupRuntime({LLAMA!r}, smoke=False): a group of "
          f"{n0} x {s0} prompt tokens, {g0} steps: prefill "
          f"{pre_s * 1e3:.1f} ms, decode {dec_s / g0 * 1e3:.2f} ms per "
          f"step; tokens equal to the steps called directly: "
          f"{np.array_equal(got, direct)}; launches "
          f"{path_launches['runtime_llama3_8b']} ({card})")
    check(np.array_equal(got, direct), "the runtime's tokens equal the "
          "steps called directly")
    check(path_launches["runtime_llama3_8b"]["rmsnorm"]
          == per_fwd * (1 + g0), "the runtime went through B4")
    del rt, params, logits, cache
    torch.cuda.empty_cache()

    # 17d. the other families at full width (the MoEs cut to 2 layers)
    for arch, layers, B, S in FAMILY_RUNS:
        fcfg = full_config(arch)
        if layers is not None:
            fcfg = dataclasses.replace(fcfg, n_layers=layers)
        t0 = time.perf_counter()
        fp = init_params(fcfg, torch.Generator(dev).manual_seed(SEED), dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        nbytes = sum(p.numel() * p.element_size() for p in fp.parameters())
        fb = make_batch(fcfg, B, S, dev)
        what = arch.replace("-", "_").replace(".", "_")
        run = counted(what, lambda: generate(fcfg, fp, fb, FAMILY_STEPS))
        seq = S + (fcfg.n_patches if fcfg.family == "vlm" else 0)
        want = {"rmsnorm": rmsnorms_per_forward(fcfg) * (1 + FAMILY_STEPS),
                "ssd_chunk": ssd_chunks_per_prefill(fcfg, seq)}
        print(f"[17d] {fcfg.name} ({fcfg.family}"
              f"{f', cut to {layers} layers' if layers else ''}; "
              f"{nbytes / 1e9:.2f} GB of weights, initialised in "
              f"{t_init:.1f} s): {B} x {S} prompt tokens"
              f"{f' after {fcfg.n_patches} patches' if fcfg.family == 'vlm' else ''}"
              f", prefill {run.prefill_s * 1e3:.1f} ms, decode "
              f"{run.decode_s / FAMILY_STEPS * 1e3:.2f} ms per step; "
              f"launches {path_launches[what]} (want {want}); sample "
              f"{run.tokens[0].tolist()} ({card})")
        check(bool(torch.isfinite(run.logits).all())
              and bool((run.tokens < fcfg.vocab_size).all()),
              f"{arch}: finite logits, tokens in the vocab")
        check(int(run.cache["pos"]) == seq + FAMILY_STEPS,
              f"{arch}: the cache's position")
        check(path_launches[what] == want,
              f"{arch}: B4 and B5 launched as the model's structure says")
        del fp, fb, run
        torch.cuda.empty_cache()

    # 17d. every architecture's smoke config, CPU plain against card
    # kernels: as published (bf16; the card fed the CPU's tokens, logits
    # held within LM_TOL) and in float32 (free-running greedy tokens
    # equal, logits within 1e-4)
    for arch in ARCH_IDS:
        line = []
        for dtype in ("bfloat16", "float32"):
            scfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
            sp = init_params(scfg, torch.Generator().manual_seed(SEED),
                             "cpu")
            sg = copy.deepcopy(sp).to(dev)
            sb = make_batch(scfg, 2, SMOKE_PROMPT, "cpu")
            if dtype == "bfloat16":
                d, agree, gap = cpu_card_forced(scfg, sp, sg, sb,
                                                CUT_STEPS, dev)
                line.append(f"bf16 max|dlogits| {d:.4f}, argmax agrees "
                            f"{100 * agree:.0f}% (narrowest CPU gap "
                            f"{gap:.4f})")
                continue
            cpu, tc = greedy_run(scfg, sp, sb, CUT_STEPS)
            gpu, tg = greedy_run(scfg, sg, {k: v.to(dev) for k, v in
                                            sb.items()}, CUT_STEPS)
            for a, b in zip(gpu, cpu):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
            check(torch.equal(tc, tg), f"{arch} smoke (f32): the same "
                  f"greedy tokens on CPU and card")
            d = max(float((a - b).abs().max()) for a, b in zip(gpu, cpu))
            gap = min(float(top2_gap(b).min()) for b in cpu)
            line.append(f"f32 max|dlogits| {d:.2e}, tokens equal "
                        f"(narrowest CPU gap {gap:.2e})")
        print(f"[17d] {arch} smoke, CPU vs card: {'; '.join(line)}")

    # 17e. B4 at the new path shapes and B5 at hymba's chunk, timed
    hy = full_config("hymba-1.5b")
    hy_S = {a: S for a, _, _, S in FAMILY_RUNS}["hymba-1.5b"]
    bf16, f32 = torch.bfloat16, torch.float32
    l3 = full_config(LLAMA)
    # name -> (rows, d, x dtype, w dtype, the run whose launches count)
    new_shapes = {
        "llama3_norm": (SERVE_BATCH * SERVE_PROMPT, l3.d_model, bf16, bf16,
                        "llama3_8b"),
        "llama3_norm_decode": (SERVE_BATCH, l3.d_model, bf16, bf16,
                               "llama3_8b"),
        "hymba_norm": (hy_S, hy.d_model, bf16, bf16, "hymba_1_5b"),
        "hymba_gated": (hy_S, hy.d_inner_ssm, f32, bf16, "hymba_1_5b"),
        "hymba_norm_decode": (1, hy.d_model, bf16, bf16, "hymba_1_5b"),
        "hymba_gated_decode": (1, hy.d_inner_ssm, f32, bf16, "hymba_1_5b")}
    shapes = {k: v[:4] + (path_shapes[v[4]].get(v[:3], 0),)
              for k, v in new_shapes.items()}
    errs = RB.check_shapes({"kernel": RK.rmsnorm}, shapes, SEED)
    t = RB.time_shapes({"kernel": RK.rmsnorm, "library": RB.library},
                       shapes, rounds=1, seed=SEED)
    for k, (r, d, xdt, wdt, n) in shapes.items():
        tk = t[k]
        x, w = torch.empty(r, d, dtype=xdt, device=dev), \
            torch.empty(d, dtype=wdt, device=dev)
        variant = RK.variant(x, w)[0]
        kc, kw = tk["kernel"]["cold"], tk["kernel"]["warm"]
        lc, lw = tk["library"]["cold"], tk["library"]["warm"]
        b_ms = tk["bound_ms"]
        print(f"[17e] rmsnorm {k} ({r}, {d}) x {xdt}, w {wdt}, {variant}: "
              f"cold {kc * 1e3:.2f} us ({100 * b_ms / kc:.1f}% of the "
              f"{b_ms * 1e3:.3f} us {tk['bound_by']} bound), warm "
              f"{kw * 1e3:.2f} us; F.rms_norm cold {lc * 1e3:.2f} us, warm "
              f"{lw * 1e3:.2f} us; max|err| {errs[k]['kernel']:.3e}; {n} "
              f"launches in {new_shapes[k][4]}'s run ({card})")
        rec["rmsnorm"]["shapes"][k] = {
            "variant": variant, "us_cold": kc * 1e3, "us_warm": kw * 1e3,
            "library_us_cold": lc * 1e3, "library_us_warm": lw * 1e3,
            "bound_us": b_ms * 1e3, "bound_by": tk["bound_by"],
            "launches": n}
    check(shapes["hymba_norm"][-1] == 2 * hy.n_layers + 1
          and shapes["hymba_gated"][-1] == hy.n_layers
          and shapes["hymba_norm_decode"][-1]
          == (2 * hy.n_layers + 1) * FAMILY_STEPS,
          "hymba ran B4 at its path shapes as its layers and steps say")
    # hymba's chunk, with x, B and C as views of one conv output as the
    # model passes them
    Bb, Q, H, P, N = 1, hy.ssm.chunk_size, hy.n_ssm_heads, hy.ssm.head_dim, \
        hy.ssm.d_state
    g = torch.Generator(dev).manual_seed(SEED)
    conv = torch.randn(Bb, Q, H * P + 2 * N, generator=g,
                       device=dev).to(bf16)
    args = (conv[..., :H * P].reshape(Bb, Q, H, P),
            torch.nn.functional.softplus(torch.randn(
                Bb, Q, H, generator=g, device=dev)),
            -torch.exp(torch.randn(H, generator=g, device=dev) * 0.3),
            conv[..., H * P:H * P + N], conv[..., H * P + N:],
            torch.randn(Bb, H, P, N, generator=g, device=dev))
    (y, hn), (yr, hr) = SK.ssd_chunk(*args), ssd_chunk_ref(*args)
    for got_, want_ in ((y, yr), (hn, hr)):
        torch.testing.assert_close(got_, want_, rtol=TOL,
                                   atol=1e-5 * float(want_.abs().max()))
    ssd_err = max(float((y - yr).abs().max()), float((hn - hr).abs().max()))
    ms = timed_ms(lambda: SK.ssd_chunk(*args), reps=50, warmup=3)
    plain_ms = timed_ms(lambda: ssd_chunk_ref(*args), reps=5, warmup=1,
                        host_paced_ok=True)
    cbt = Bb * Q * (Q + 1) * N
    per_head = Q * (Q + 1) * P + 4 * Q * P * N
    b_ms, b_by = bound(list(args) + [y, hn], 1, Bb * H * per_head,
                       bf16_tc_flops=cbt)
    b2_ms, b2_by = bound(list(args) + [y, hn], 0, 0,
                         bf16_tc_flops=3 * Bb * H * per_head + cbt)
    if b2_ms < b_ms:
        b_ms, b_by = b2_ms, b2_by
    n5 = path_launches["hymba_1_5b"]["ssd_chunk"]
    print(f"[17e] ssd_chunk at hymba's chunk {(Bb, Q, H, P, N)} (bf16 x, B, "
          f"C as views): {ms * 1e3:.1f} us, {100 * b_ms / ms:.1f}% of the "
          f"{b_ms * 1e3:.2f} us {b_by} bound; plain {plain_ms:.3f} ms; "
          f"max|err| {ssd_err:.3e}; {n5} launches in [17d]'s prefill "
          f"({card})")
    rec["ssd_chunk"]["shapes"] = {"hymba_chunk": {
        "shape": [Bb, Q, H, P, N], "us": ms * 1e3, "plain_ms": plain_ms,
        "bound_us": b_ms * 1e3, "bound_by": b_by, "max_abs_err": ssd_err,
        "launches": n5}}
    for name in ("rmsnorm", "ssd_chunk"):
        rec[name]["launches_by_serve_path"] = {
            k: v[name] for k, v in path_launches.items()}
    t17 = time.perf_counter() - t17
    print(f"[17] phase 17 took {t17:.1f} s ({card})")
    return t17


def train_launches(cfg, tc, seq: int) -> dict:
    """B4 and B5 launches of one train step over ``seq`` positions, from
    the model's structure and the remat policy: each microbatch runs
    every decoder layer forward once, and backward runs it again once
    ("layer") or, under sqrt-remat's nested checkpoints, twice but for
    the last layer of each block, before which the block's recompute
    stops ("block": 2 bs - 1 a block of bs layers); the final norm runs
    once, and the kernels' backward (their plain versions) launches
    nothing."""
    from repro_torch.models.transformer import block_size
    L, bs = cfg.n_layers, block_size(cfg.n_layers)
    runs = {"none": L, "layer": 2 * L,
            "block": L + L // bs * (2 * bs - 1)}[tc.remat]
    final = int(cfg.norm_variant == "rmsnorm")
    check(cfg.family != "encdec" or not final,
          "train_launches counts no RMSNorm encoder")
    per_layer = (rmsnorms_per_forward(cfg) - final) // L
    M = tc.microbatches
    return {"rmsnorm": M * (per_layer * runs + final),
            "ssd_chunk": M * ssd_chunks_per_prefill(cfg, seq) // L * runs}


def bf16_ulp(t) -> "torch.Tensor":
    """The spacing of bfloat16 values at |t| (8 significant bits)."""
    import torch
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def compare_train(cpu: dict, card: dict, dtype: str, tc) -> dict:
    """CPU against card after the same two steps from the same weights:
    each gradient leaf (at the initial weights) within TRAIN_GRAD_TOL of
    its largest |g|, the first moment after step 2 too (the clipped
    gradients the steps used) and the second within twice that (a
    square), the losses within TRAIN_LOSS_TOL.  The parameters after
    step 2 (lr > 0; step 1's is 0): each device moved them by lr (d + wd
    p0), with d = m_hat / (sqrt(v_hat) + eps) from its own moments, so
    their CPU-card difference must be lr (d_card - d_cpu) within
    TRAIN_P_TOL (float32 rounding; bfloat16: one ulp of the parameter
    more).  Adam normalises each element, so where |g| is near eps a
    gradient difference far below TRAIN_GRAD_TOL moves a parameter by
    up to 2 lr: the raw difference and the count of elements whose
    gradients differ in sign are reported.  Returns the statistics and
    the failures."""
    import torch
    tol = TRAIN_GRAD_TOL[dtype]
    bc1, bc2 = 1 - tc.beta1 ** 2, 1 - tc.beta2 ** 2
    lr = cpu["lr"]
    st = {"grad_share": 0.0, "param_diff": 0.0, "residual": 0.0,
          "flips": 0, "n": 0}
    bad = []

    def within(what, k, a, b, share):
        scale = float(b.abs().max())
        got = float((a - b).abs().max()) / scale if scale else 0.0
        if got > share:
            bad.append(f"{what} {k}: {got:.2e} of its largest value "
                       f"{scale:.3e} apart")
        return got

    p_card = dict(card["params"].named_parameters())
    for k, p in cpu["params"].named_parameters():
        gc, gg = cpu["grads"][k].double(), card["grads"][k].double().cpu()
        st["grad_share"] = max(st["grad_share"],
                               within("gradient", k, gg, gc, tol))
        st["flips"] += int((gc * gg < 0).sum()
                           + ((gc == 0) != (gg == 0)).sum())
        st["n"] += gc.numel()
        d = {}
        for w, r in (("cpu", cpu), ("card", card)):
            m, v = r["m"][k].double().cpu(), r["v"][k].double().cpu()
            d[w] = (m / bc1) / (torch.sqrt(v / bc2) + tc.eps)
            if w == "card":
                within("first moment", k, m, cpu["m"][k].double(), tol)
                within("second moment", k, v, cpu["v"][k].double(),
                       2 * tol)
        a, b = p.detach().double(), p_card[k].detach().double().cpu()
        want = lr * (d["card"] - d["cpu"])
        resid = ((a - b) - want).abs()
        allowed = TRAIN_P_TOL + (bf16_ulp(torch.maximum(a.abs(), b.abs()))
                                 .double() if dtype == "bfloat16" else 0)
        if not bool((resid <= allowed).all()):
            i = int(torch.argmax(resid - allowed))
            bad.append(f"parameter {k} after step 2: CPU-card difference "
                       f"{float((a - b).reshape(-1)[i]):.3e} where the "
                       f"moments imply {float(want.reshape(-1)[i]):.3e}")
        st["param_diff"] = max(st["param_diff"], float((a - b).abs().max()))
        st["residual"] = max(st["residual"], float(resid.max()))
    for i, (a, b) in enumerate(zip(cpu["losses"], card["losses"])):
        if abs(a - b) > TRAIN_LOSS_TOL[dtype] * abs(a):
            bad.append(f"loss {i}: {a} (CPU), {b} (card)")
    return st, bad


def phase18(dev, card: str, records: list) -> float:
    """[18] The train step on the card: (a) mamba2-370m at its published
    widths, remat "layer", 2 microbatches of 2 x 2048, 6 steps on one
    batch, B4/B5 launches exact, one step profiled; (b) its 2-layer cut,
    CPU against card at f32 and bf16; (c) llama3-8b cut to 2 layers at
    full width, remat "layer" and "block"; (d) every smoke config's step,
    CPU against card; (e) B4 and B5 at the train shapes, checked and
    timed, and the plain SSD backward timed.  Returns the phase's
    seconds."""
    import copy
    import dataclasses
    import statistics

    import torch

    from repro_torch.config import (ARCH_IDS, MeshConfig, ShapeConfig,
                                    TrainConfig, full_config, smoke_config)
    from repro_torch.data import SyntheticLMData, make_batch_iterator
    from repro_torch.kernels.dgemm import kernel as G
    from repro_torch.kernels.dslash import kernel as K
    from repro_torch.kernels.rmsnorm import bench as RB
    from repro_torch.kernels.rmsnorm import kernel as RK
    from repro_torch.kernels.ssd_chunk import kernel as SK
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
    from repro_torch.kernels.timing import bound, timed_ms
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.memplan import estimate_train_bytes
    from repro_torch.runtime.steps import loss_and_grads, make_train_step

    t18 = time.perf_counter()
    torch.cuda.empty_cache()
    rec = {r["name"]: r for r in records}
    path = {}         # run -> {kernel: launches}, summed over its calls
    shapes_by = {}    # run -> {(rows, d, x dtype): B4 launches}
    one_card = MeshConfig((1, 1), ("data", "model"))
    bf16, f32 = torch.bfloat16, torch.float32

    def counted(what, fn):
        """fn() with every kernel's count from 0; returns fn's result and
        this call's launches, and adds them to the run's."""
        for mod in (K, G, RK, SK):
            mod.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        now = {**K.LAUNCHES, **G.LAUNCHES, **RK.LAUNCHES, **SK.LAUNCHES}
        run = path.setdefault(what, dict.fromkeys(now, 0))
        for k, v in now.items():
            run[k] += v
        shapes = shapes_by.setdefault(what, {})
        for k, v in RK.SHAPE_LAUNCHES.items():
            shapes[k] = shapes.get(k, 0) + v
        return out, now

    def lm_batch(cfg, B, S, where):
        b = SyntheticLMData(cfg.vocab_size, S, B, seed=SEED).batch(0)
        return {k: torch.from_numpy(v).to(where) for k, v in b.items()}

    # 18a. mamba2-370m at its published widths
    cfg = full_config(ARCH)
    tc = TrainConfig(**TRAIN_TC)
    want = train_launches(cfg, tc, TRAIN_SEQ)
    check(want == {"rmsnorm": 386, "ssd_chunk": 1536},
          "mamba2's step: 2 x (97 + 96) B4, 2 x (384 + 384) B5")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()      # by the earlier phases
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    opt = adamw_init(params)
    batch = lm_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, dev)
    step = make_train_step(cfg, tc)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    losses, walls, lrs = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        (params, opt, m), now = counted(
            "mamba2_370m", lambda: step(params, opt, batch))
        walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
        check(now["rmsnorm"] == want["rmsnorm"]
              and now["ssd_chunk"] == want["ssd_chunk"],
              f"step {i}: B4 {now['rmsnorm']}, B5 {now['ssd_chunk']} "
              f"launches, want {want}")
    peak = torch.cuda.max_memory_allocated() - held
    shape = ShapeConfig("t", TRAIN_SEQ, TRAIN_BATCH, "train")
    est = estimate_train_bytes(cfg, shape, one_card, tc)
    wall = statistics.median(walls[1:])
    rows = TRAIN_BATCH // tc.microbatches * TRAIN_SEQ
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[18a] {cfg.name} train step at full width ({cfg.n_layers} "
          f"layers, {n_params} parameters, {cfg.dtype}, f32 moments; "
          f"initialised in {t_init:.2f} s): {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens a step in {tc.microbatches} microbatches, remat "
          f"{tc.remat!r}, {TRAIN_STEPS} steps on one batch: losses "
          f"{[round(v, 4) for v in losses]}, lr {lrs}; step walls "
          f"{[round(w * 1e3, 1) for w in walls]} ms (median of steps 2-"
          f"{TRAIN_STEPS} {wall * 1e3:.1f} ms, "
          f"{TRAIN_BATCH * TRAIN_SEQ / wall:.0f} tokens/s); peak memory "
          f"{peak / 1e9:.2f} GB allocated beyond the earlier phases' "
          f"{held / 1e9:.2f} GB, estimate_train_bytes "
          f"{est / 1e9:.2f} GB (MeshConfig((1, 1))); launches per step "
          f"B4 {want['rmsnorm']}, B5 {want['ssd_chunk']} ({card})")
    check(all(math.isfinite(v) for v in losses), "finite losses")
    check(losses[-1] < losses[0] - TRAIN_LOSS_DROP,
          f"the loss falls by more than {TRAIN_LOSS_DROP} in "
          f"{TRAIN_STEPS} steps")
    check(shapes_by["mamba2_370m"] == {
        (rows, cfg.d_model, bf16): TRAIN_STEPS * 2 * 97,
        (rows, cfg.d_inner_ssm, f32): TRAIN_STEPS * 2 * 96},
        "B4 at (4096, 1024) bf16 and (4096, 2048) f32 as the layers say")
    prof = device_activity(
        lambda: step(params, opt, batch),
        ops=("SSDChunkFunctionBackward", "RMSNormFunctionBackward"))
    _, pwall, busy, count, _, ops = prof
    print_activity(f"one {ARCH} train step", pwall, busy, count,
                   tag="[18a]")
    total = sum(busy.values())
    for what, key in (("B5 (SSD chunk, forward)", "ssd_chunk_kernel"),
                      ("B4 (RMSNorm, forward)", "rmsnorm_kernel")):
        t = sum(v for k, v in busy.items() if key in k)
        n = sum(v for k, v in count.items() if key in k)
        print(f"[18a] {what}: {t * 1e3:.2f} ms in {n} launches, "
              f"{100 * t / total:.1f}% of the device's busy time")
    for op, (t, n, acts) in ops.items():
        print(f"[18a] {op} (the plain version's recompute and backward): "
              f"{t * 1e3:.2f} ms of device time in {n} calls, "
              f"{100 * t / total:.1f}% of the busy time; {acts} of the "
              f"step's {sum(count.values())} device activities")
    del params, opt, batch, step, m
    torch.cuda.empty_cache()

    # 18b. the 2-layer cut at full width, CPU (plain) against card
    Lc, Bc, Sc = TRAIN_CUT
    tc_b = TrainConfig(remat="layer", warmup_steps=1, learning_rate=3e-3)
    for dtype in ("float32", "bfloat16"):
        cut = dataclasses.replace(cfg, n_layers=Lc, dtype=dtype)
        p_cpu = init_params(cut, torch.Generator().manual_seed(SEED), "cpu")
        runs = {}
        t0 = time.perf_counter()
        for where, p in (("cpu", p_cpu), ("card", copy.deepcopy(p_cpu))):
            p = p.to("cpu" if where == "cpu" else dev)
            b = lm_batch(cut, Bc, Sc, p.embed.tokens.device)

            def run():
                _, _, g = loss_and_grads(cut, tc_b, p.requires_grad_(), b)
                st, o, ls = make_train_step(cut, tc_b), adamw_init(p), []
                for _ in range(2):
                    _, o, mm = st(p, o, b)
                    ls.append(float(mm["loss"]))
                return {"grads": g, "losses": ls, "params": p,
                        "lr": float(mm["lr"]), "m": o["m"], "v": o["v"]}

            runs[where] = (counted(f"mamba2_cut_{dtype}", run)[0]
                           if where == "card" else run())
            runs[where + "_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        res, bad = compare_train(runs["cpu"], runs["card"], dtype, tc_b)
        one = train_launches(cut, tc_b, Sc)
        got = path[f"mamba2_cut_{dtype}"]
        print(f"[18b] {cut.n_layers} layers at full width, {dtype}, "
              f"{Bc} x {Sc}: losses {runs['cpu']['losses']} (CPU), "
              f"{runs['card']['losses']} (card); gradients within "
              f"{res['grad_share']:.2e} of each leaf's max|g| (tolerance "
              f"{TRAIN_GRAD_TOL[dtype]}); after step 2 (lr "
              f"{runs['cpu']['lr']:.3g}) the parameters apart by up to "
              f"{res['param_diff']:.3e}, and by {res['residual']:.3e} at "
              f"most beyond what the moments imply (tolerance "
              f"{TRAIN_P_TOL}{' + one ulp' if dtype == 'bfloat16' else ''});"
              f" {res['flips']} of {res['n']} gradient elements of "
              f"opposite sign or zero on one side only; "
              f"{runs['cpu_s']:.1f} s on the CPU, {runs['card_s']:.1f} s on "
              f"the card; card launches B4 {got['rmsnorm']}, B5 "
              f"{got['ssd_chunk']} ({card})")
        for line in bad[:10]:
            print(f"[18b]   {line}")
        check(not bad, f"{dtype}: the cut's gradients, losses and "
              f"parameters agree on CPU and card ({len(bad)} failures)")
        check(got["rmsnorm"] == 3 * one["rmsnorm"]
              and got["ssd_chunk"] == 3 * one["ssd_chunk"],
              "the cut on the card: B4/B5 as its structure says, 3 passes")
        del runs, p_cpu
    torch.cuda.empty_cache()

    # 18c. llama3-8b cut to 2 layers at full width: remat layer and block
    Ll, Bl, Sl = LLAMA_TRAIN
    lcfg = dataclasses.replace(full_config(LLAMA), n_layers=Ll)
    lshape = ShapeConfig("t", Sl, Bl, "train")
    llama = {}
    for policy in ("layer", "block"):
        tcl = TrainConfig(remat=policy, warmup_steps=1,
                          learning_rate=LLAMA_TRAIN_LR)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        p = init_params(lcfg, torch.Generator(dev).manual_seed(SEED), dev)
        o = adamw_init(p)
        lb = lm_batch(lcfg, Bl, Sl, dev)
        st = make_train_step(lcfg, tcl)
        one = train_launches(lcfg, tcl, Sl)
        ls, ws = [], []
        for i in range(LLAMA_TRAIN_STEPS):
            t0 = time.perf_counter()
            (p, o, mm), now = counted(f"llama3_8b_cut_{policy}",
                                      lambda: st(p, o, lb))
            ws.append(time.perf_counter() - t0)
            ls.append(float(mm["loss"]))
            check(now["rmsnorm"] == one["rmsnorm"]
                  and now["ssd_chunk"] == 0,
                  f"llama3-8b cut, {policy}: B4 {now['rmsnorm']} a step, "
                  f"want {one['rmsnorm']}")
        peak = torch.cuda.max_memory_allocated() - held
        est = estimate_train_bytes(lcfg, lshape, one_card, tcl)
        n_params = sum(t.numel() for t in p.parameters())
        llama[policy] = ls
        print(f"[18c] {LLAMA} cut to {Ll} layers at full width ({n_params} "
              f"parameters: {2 * n_params / 1e9:.2f} GB bf16, "
              f"{8 * n_params / 1e9:.2f} GB f32 moments), {Bl} x {Sl}, "
              f"remat {policy!r}: losses {[round(v, 5) for v in ls]}, step "
              f"walls {[round(w * 1e3, 1) for w in ws]} ms; peak "
              f"{peak / 1e9:.2f} GB allocated beyond the "
              f"{held / 1e9:.2f} GB held before, estimate_train_bytes "
              f"{est / 1e9:.2f} GB; B4 {one['rmsnorm']} a step ({card})")
        check(all(math.isfinite(v) for v in ls) and ls[-1] < ls[0],
              f"llama3-8b cut, {policy}: finite losses, falling once the "
              f"rate is above 0")
        del p, o, st, mm
        torch.cuda.empty_cache()
    d = max(abs(a - b) for a, b in zip(llama["layer"], llama["block"]))
    print(f"[18c] remat 'layer' against 'block': losses within {d:.2e}")
    check(d < 1e-3, "remat 'layer' and 'block' give the same losses "
          "(within 1e-3, the reference's criterion)")

    # 18d. every architecture's smoke config, one step, CPU against card
    Bs, Ss = TRAIN_SMOKE
    tc_d = TrainConfig(warmup_steps=1, learning_rate=3e-3)
    for arch in ARCH_IDS:
        scfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        seq = Ss + (scfg.n_patches if scfg.family == "vlm" else 0)
        nb = next(make_batch_iterator(scfg, ShapeConfig("t", seq, Bs,
                                                        "train"), seed=SEED))
        sp = init_params(scfg, torch.Generator().manual_seed(SEED), "cpu")
        runs = {}
        for where, p in (("cpu", sp), ("card", copy.deepcopy(sp))):
            p = p.to("cpu" if where == "cpu" else dev)
            b = {k: torch.from_numpy(v).to(p.embed.tokens.device)
                 for k, v in nb.items()}

            def run():
                loss, _, g = loss_and_grads(scfg, tc_d, p.requires_grad_(), b)
                _, _, mm = make_train_step(scfg, tc_d)(p, adamw_init(p), b)
                return {"grads": g, "losses": [float(loss)],
                        "grad_norm": float(mm["grad_norm"]), "params": p}

            runs[where] = (counted(f"smoke_{arch}", run)[0]
                           if where == "card" else run())
        worst = 0.0
        for k, gc in runs["cpu"]["grads"].items():
            gg = runs["card"]["grads"][k].cpu()
            scale = float(gc.abs().max())
            share = float((gg - gc).abs().max()) / scale if scale else 0.0
            worst = max(worst, share)
            check(share <= TRAIN_GRAD_TOL["float32"],
                  f"{arch} smoke: gradient {k} {share:.2e} of max|g| apart")
        lc, lg = runs["cpu"]["losses"][0], runs["card"]["losses"][0]
        check(abs(lc - lg) <= TRAIN_LOSS_TOL["float32"] * abs(lc)
              and abs(runs["cpu"]["grad_norm"] - runs["card"]["grad_norm"])
              <= TRAIN_LOSS_TOL["float32"] * runs["cpu"]["grad_norm"],
              f"{arch} smoke: loss and grad norm on CPU and card")
        one = train_launches(scfg, tc_d, seq)
        got = path[f"smoke_{arch}"]
        check(got["rmsnorm"] == 2 * one["rmsnorm"]
              and got["ssd_chunk"] == 2 * one["ssd_chunk"],
              f"{arch} smoke: B4/B5 launched as its structure says")
        print(f"[18d] {arch} smoke (f32, {Bs} x {seq}), CPU vs card: loss "
              f"{lc:.6f} / {lg:.6f}, gradients within {worst:.2e} of each "
              f"leaf's max|g|; card launches B4 {got['rmsnorm']}, B5 "
              f"{got['ssd_chunk']}")
        del runs, sp

    # 18e. B4 at the train shapes, B5 at the microbatch's chunk
    rows_l = Bl * Sl
    train_shapes = {
        "train_norm": (rows, cfg.d_model, bf16, bf16, "mamba2_370m"),
        "train_gated": (rows, cfg.d_inner_ssm, f32, bf16, "mamba2_370m"),
        "llama3_train_norm": (rows_l, lcfg.d_model, bf16, bf16,
                              "llama3_8b_cut_layer")}
    shapes = {k: v[:4] + (shapes_by[v[4]].get(v[:3], 0),)
              for k, v in train_shapes.items()}
    errs = RB.check_shapes({"kernel": RK.rmsnorm}, shapes, SEED)
    t = RB.time_shapes({"kernel": RK.rmsnorm, "library": RB.library},
                       shapes, rounds=1, seed=SEED)
    for k, (r, dd, xdt, wdt, n) in shapes.items():
        tk = t[k]
        kc, kw = tk["kernel"]["cold"], tk["kernel"]["warm"]
        lc, lw = tk["library"]["cold"], tk["library"]["warm"]
        b_ms = tk["bound_ms"]
        print(f"[18e] rmsnorm {k} ({r}, {dd}) x {xdt}, w {wdt}: cold "
              f"{kc * 1e3:.2f} us ({100 * b_ms / kc:.1f}% of the "
              f"{b_ms * 1e3:.3f} us {tk['bound_by']} bound), warm "
              f"{kw * 1e3:.2f} us; F.rms_norm cold {lc * 1e3:.2f} us, warm "
              f"{lw * 1e3:.2f} us; max|err| {errs[k]['kernel']:.3e}; {n} "
              f"launches in {train_shapes[k][4]}'s run ({card})")
        rec["rmsnorm"]["shapes"][k] = {
            "us_cold": kc * 1e3, "us_warm": kw * 1e3,
            "library_us_cold": lc * 1e3, "library_us_warm": lw * 1e3,
            "bound_us": b_ms * 1e3, "bound_by": tk["bound_by"],
            "launches": n}
    # the microbatch's chunk, x, B and C as views of one conv output
    Bb, Q = TRAIN_BATCH // tc.microbatches, cfg.ssm.chunk_size
    H, P, N = cfg.n_ssm_heads, cfg.ssm.head_dim, cfg.ssm.d_state
    g = torch.Generator(dev).manual_seed(SEED)
    conv = torch.randn(Bb, Q, H * P + 2 * N, generator=g,
                       device=dev).to(bf16)
    rest = [torch.nn.functional.softplus(torch.randn(
        Bb, Q, H, generator=g, device=dev)),
        -torch.exp(torch.randn(H, generator=g, device=dev) * 0.3),
        torch.randn(Bb, H, P, N, generator=g, device=dev)]

    def views(conv, dt, A, h):
        return (conv[..., :H * P].reshape(Bb, Q, H, P), dt, A,
                conv[..., H * P:H * P + N], conv[..., H * P + N:], h)

    args = views(conv, *rest)
    (y, hn), (yr, hr) = SK.ssd_chunk(*args), ssd_chunk_ref(*args)
    for got_, want_ in ((y, yr), (hn, hr)):
        torch.testing.assert_close(got_, want_, rtol=TOL,
                                   atol=1e-5 * float(want_.abs().max()))
    ssd_err = max(float((y - yr).abs().max()), float((hn - hr).abs().max()))
    ms = timed_ms(lambda: SK.ssd_chunk(*args), reps=50, warmup=3)
    plain_ms = timed_ms(lambda: ssd_chunk_ref(*args), reps=5, warmup=1,
                        host_paced_ok=True)
    leaves = [t.clone().requires_grad_() for t in [conv] + rest]
    gy, gh = torch.randn_like(y), torch.randn_like(hn)

    def plain_backward():
        torch.autograd.grad(ssd_chunk_ref(*views(*leaves)), leaves, (gy, gh))

    bwd_ms = timed_ms(plain_backward, reps=5, warmup=1, host_paced_ok=True)
    cbt = Bb * Q * (Q + 1) * N
    per_head = Q * (Q + 1) * P + 4 * Q * P * N
    b_ms, b_by = bound(list(args) + [y, hn], 1, Bb * H * per_head,
                       bf16_tc_flops=cbt)
    b2_ms, b2_by = bound(list(args) + [y, hn], 0, 0,
                         bf16_tc_flops=3 * Bb * H * per_head + cbt)
    if b2_ms < b_ms:
        b_ms, b_by = b2_ms, b2_by
    n5 = path["mamba2_370m"]["ssd_chunk"]
    print(f"[18e] ssd_chunk at the microbatch's chunk {(Bb, Q, H, P, N)} "
          f"(bf16 x, B, C as views): {ms * 1e3:.1f} us, "
          f"{100 * b_ms / ms:.1f}% of the {b_ms * 1e3:.2f} us {b_by} bound;"
          f" plain {plain_ms:.3f} ms; the plain backward (recompute and "
          f"autograd.grad, what SSDChunkFunction's backward runs) "
          f"{bwd_ms:.3f} ms, {bwd_ms / ms:.0f}x the kernel's forward; "
          f"max|err| {ssd_err:.3e}; {n5} launches in [18a]'s "
          f"{TRAIN_STEPS} steps ({card})")
    rec["ssd_chunk"]["shapes"]["train_chunk"] = {
        "shape": [Bb, Q, H, P, N], "us": ms * 1e3, "plain_ms": plain_ms,
        "plain_backward_ms": bwd_ms, "bound_us": b_ms * 1e3,
        "bound_by": b_by, "max_abs_err": ssd_err, "launches": n5}
    for r in records:
        r["launches_by_train_path"] = {k: own_launches(v, r["name"])
                                       for k, v in path.items()}
    t18 = time.perf_counter() - t18
    print(f"[18] phase 18 took {t18:.1f} s ({card})")
    return t18


def train_state(params, opt) -> list:
    """A copy of every tensor a train step writes (the parameters, the
    AdamW moments and step count), on their device."""
    return [t.detach().clone() for t in (*params.parameters(),
                                         *opt["m"].values(),
                                         *opt["v"].values(), opt["step"])]


def phase19(dev, card: str, records: list) -> float:
    """[19] The training driver on the card: (a) mamba2-370m at its
    published widths through ``launch.train.main``, its checkpoints and
    energy lines; (b) the fault path on its 2-layer cut; (c) the smoke
    configs on the CPU and the card; (d) the five examples.  Returns the
    phase's seconds."""
    import contextlib
    import dataclasses
    import importlib.util
    import io
    import shutil
    import statistics
    import tempfile
    import types
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch.autotune import set_default_cache
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import (MeshConfig, ShapeConfig, TrainConfig,
                                    full_config, get_arch)
    from repro_torch.distributed.fault import FaultPolicy
    from repro_torch.kernels.dgemm import kernel as G
    from repro_torch.kernels.dslash import kernel as K
    from repro_torch.kernels.rmsnorm import kernel as RK
    from repro_torch.kernels.ssd_chunk import kernel as SK
    from repro_torch.launch import train as T
    from repro_torch.runtime.memplan import estimate_train_bytes
    from repro_torch.runtime.steps import make_train_step

    t19 = time.perf_counter()
    torch.cuda.empty_cache()
    mods = (K, G, RK, SK)
    path = {}         # run -> {kernel: launches}, summed over its calls

    def reset():
        for mod in mods:
            mod.reset_launches()

    def read():
        return {**K.LAUNCHES, **G.LAUNCHES, **RK.LAUNCHES, **SK.LAUNCHES}

    def add(run, now):
        tot = path.setdefault(run, dict.fromkeys(now, 0))
        for k, v in now.items():
            tot[k] += v

    def counting(run, per_step, bad=(), on_entry=None, on_exit=None):
        """make_train_step, each step's launches counted from 0 (and
        added to ``run``'s), the loss of the calls in ``bad`` made NaN;
        ``on_entry(i, params, opt)`` and ``on_exit`` see the state."""
        def make(cfg, tc):
            step = make_train_step(cfg, tc)

            def wrapped(params, opt, batch):
                i = len(per_step)
                if on_entry:
                    on_entry(i, params, opt)
                reset()
                params, opt, m = step(params, opt, batch)
                now = read()
                per_step.append(now)
                add(run, now)
                if on_exit:
                    on_exit(i, params, opt)
                if i in bad:
                    m = dict(m, loss=torch.full((), math.nan,
                                                device=m["loss"].device))
                return params, opt, m
            return wrapped
        return make

    def driver(argv, buf):
        with contextlib.redirect_stdout(buf):
            return T.main(argv)

    one_card = MeshConfig((1, 1), ("data", "model"))
    ckroot = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        # 19a. mamba2-370m at its published widths through the driver
        cfg = full_config(ARCH)
        tc = TrainConfig(remat="none")      # the driver's
        want = train_launches(cfg, tc, DRIVER_SEQ)
        last_ckpt = max(s for s in range(DRIVER_STEPS)
                        if s % DRIVER_EVERY == 0)
        saves, waits, at_ckpt = [], [], {}

        class Manager(CheckpointManager):
            """Times save() and wait(); keeps a host copy of the
            parameters at the last checkpointed step."""

            def save(self, step, tree, blocking=False):
                t0 = time.perf_counter()
                super().save(step, tree, blocking)
                saves.append((step, time.perf_counter() - t0))
                if step == last_ckpt:
                    at_ckpt["params"] = [p.detach().to("cpu", copy=True)
                                         for p in tree.parameters()]

            def wait(self):
                t0 = time.perf_counter()
                super().wait()
                waits.append(time.perf_counter() - t0)

        per_step, buf = [], io.StringIO()
        argv = ["--arch", ARCH, "--full", "--batch", str(DRIVER_BATCH),
                "--seq", str(DRIVER_SEQ), "--steps", str(DRIVER_STEPS),
                "--ckpt-every", str(DRIVER_EVERY), "--log-every", "1",
                "--device", "cuda", "--ckpt-dir", str(ckroot / "a")]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with mock.patch.multiple(
                T, make_train_step=counting("driver_mamba2_370m", per_step),
                CheckpointManager=Manager), PowerSamples() as ps:
            run = driver(argv, buf)
        t_run = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        est = estimate_train_bytes(
            cfg, ShapeConfig("t", DRIVER_SEQ, DRIVER_BATCH, "train"),
            one_card, tc)
        losses = [h.loss for h in run.loop.history]
        walls = [h.wall_s for h in run.loop.history]
        wall = statistics.median(walls[1:])
        ckdir = ckroot / "a" / cfg.name
        nbytes = {s: sum(f.stat().st_size
                         for f in (ckdir / f"step_{s:08d}").iterdir())
                  for s in run.ckpt.steps()}
        for line in buf.getvalue().splitlines():
            print(f"[19a]   {line}")
        print(f"[19a] launch.train {ARCH} --full: {cfg.n_layers} layers, "
              f"{DRIVER_BATCH} x {DRIVER_SEQ} tokens a step, remat "
              f"{tc.remat!r}, {DRIVER_STEPS} steps in {t_run:.1f} s: "
              f"losses {[round(v, 4) for v in losses]}; step walls "
              f"{[round(w * 1e3, 1) for w in walls]} ms (median of steps "
              f"2-{DRIVER_STEPS} {wall * 1e3:.1f} ms, "
              f"{DRIVER_BATCH * DRIVER_SEQ / wall:.0f} tokens/s); launches "
              f"a step B4 {[c['rmsnorm'] for c in per_step]}, B5 "
              f"{[c['ssd_chunk'] for c in per_step]} (the structure says "
              f"{want['rmsnorm']} and {want['ssd_chunk']}); peak memory "
              f"{peak / 1e9:.2f} GB beyond the {held / 1e9:.2f} GB held "
              f"before, estimate_train_bytes {est / 1e9:.2f} GB "
              f"(MeshConfig((1, 1))) ({card})")
        print(f"[19a] checkpoints: save() blocked "
              f"{[(st, round(t * 1e3, 1)) for st, t in saves]} ms (step, "
              f"ms: the host snapshot, and the wait for the previous "
              f"write); the final wait() {waits[-1] * 1e3:.1f} ms; steps "
              f"kept {run.ckpt.steps()}, {nbytes} bytes each (f32 on "
              f"disk)")
        print(f"[19a] nvidia-smi over the run: {ps.mean_w:.2f} W mean of "
              f"{len(ps.watts)} samples, SM clock "
              f"{sum(ps.clocks) / len(ps.clocks):.0f} MHz mean, beside the "
              f"driver's modelled [energy] lines above ({card})")
        check(all(math.isfinite(v) for v in losses), "finite losses")
        check(all(c["rmsnorm"] == want["rmsnorm"]
                  and c["ssd_chunk"] == want["ssd_chunk"]
                  and c["dslash_split"] == c["dslash_eo_split"]
                  == c["dgemm"] == 0 for c in per_step)
              and len(per_step) == DRIVER_STEPS,
              f"B4 and B5 launched {want} a step through the driver")
        check(run.ckpt.steps() == [0, 2, 4] and not run.loop.rollbacks,
              "the driver checkpointed steps 0, 2 and 4, no rollback")
        t0 = time.perf_counter()
        fresh = T.make_params(cfg, SEED + 1, dev)
        got = run.ckpt.restore(last_ckpt, fresh)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        same = all(torch.equal(p, q.to(dev)) for p, q in
                   zip(got.parameters(), at_ckpt["params"]))
        n_p = sum(p.numel() for p in got.parameters())
        print(f"[19a] restore({last_ckpt}) into a fresh model on the card: "
              f"{n_p} parameters bit-equal to the driver's at step "
              f"{last_ckpt}: {same}; {t_restore:.2f} s with the model's "
              f"construction")
        check(same, "the newest checkpoint restores bit for bit")
        del run, fresh, got, at_ckpt["params"]
        torch.cuda.empty_cache()

        # 19b. the fault path on the 2-layer cut
        Lc, Bc, Sc, n_steps = FAULT_RUN
        cut = dataclasses.replace(cfg, n_layers=Lc)
        retries = FaultPolicy().max_retries
        rule = {"bad": 0, "last_good": None, "next": None}
        seen, bad_state = [], []

        def on_entry(i, params, opt):
            state = train_state(params, opt)
            if rule["next"] is not None:
                kind, want_state = rule["next"]
                ok = all(torch.equal(a, b) for a, b in zip(state,
                                                           want_state))
                seen.append((i, kind, ok))
            rule["entered"] = state

        def on_exit(i, params, opt):
            left = train_state(params, opt)
            if i in FAULT_BAD:
                rule["bad"] += 1
                bad_state.append(not all(torch.equal(a, b) for a, b in
                                         zip(left, rule["entered"])))
                if rule["bad"] <= retries:
                    rule["next"] = (("back to step "
                                     f"{rule['last_good'][0]}",
                                     rule["last_good"][1])
                                    if rule["last_good"] else
                                    ("undone", rule["entered"]))
                    return
                rule["next"] = ("kept", left)
            else:
                rule["next"] = ("next", left)
            if i % DRIVER_EVERY == 0:
                rule["last_good"] = (i, left)

        per_b, buf = [], io.StringIO()
        entry = types.SimpleNamespace(full=lambda: cut, smoke=lambda: cut)
        with mock.patch.multiple(T, make_train_step=counting(
                "driver_fault_cut", per_b, FAULT_BAD, on_entry, on_exit),
                get_arch=lambda a: entry):
            run = driver(["--arch", ARCH, "--full", "--batch", str(Bc),
                          "--seq", str(Sc), "--steps", str(n_steps),
                          "--ckpt-every", str(DRIVER_EVERY), "--log-every",
                          "1", "--device", "cuda", "--ckpt-dir",
                          str(ckroot / "b")], buf)
        faults = [ln for ln in buf.getvalue().splitlines()
                  if ln.startswith("[fault]")]
        n_bad = len(FAULT_BAD)
        print(f"[19b] {Lc} layers at full width, {Bc} x {Sc}, {n_steps} "
              f"steps, non-finite losses injected at steps "
              f"{list(FAULT_BAD)}: {len(faults)} rolled back "
              f"({[ln.split(':')[0] for ln in faults]}), rollback count "
              f"{run.loop.rollbacks} (the reference's rule: every "
              f"non-finite step counts, the first {retries} roll back); "
              f"the state entering each next step, bit for bit: "
              f"{[(i, k, ok) for i, k, ok in seen if k != 'next']}; "
              f"checkpoints kept {run.ckpt.steps()} ({card})")
        check(all(bad_state), "each bad step wrote the state in place")
        check(all(ok for _, _, ok in seen) and len(seen) == n_steps - 1,
              "after each rollback the parameters and AdamW state equal "
              "the last checkpointed step's (or the state before the "
              "step), bit for bit; kept past the retries")
        check({k.split(" ")[0] for _, k, _ in seen}
              == {"next", "undone", "back", "kept"},
              "the fault run covers undo, rollback and kept")
        check(run.loop.rollbacks == n_bad
              and len(faults) == min(n_bad, retries),
              f"rollbacks {run.loop.rollbacks}, want {n_bad}; "
              f"{min(n_bad, retries)} rolled back")
        del run, rule, seen
        torch.cuda.empty_cache()

        # 19c. the smoke configs, CPU against card, float32
        archs, Bs, Ss, n_s = DRIVER_SMOKE
        make_params = T.make_params
        for arch in archs:
            scfg = dataclasses.replace(get_arch(arch).smoke(),
                                       dtype="float32")
            entry = types.SimpleNamespace(smoke=lambda: scfg,
                                          full=lambda: scfg)
            runs, per_c = {}, []
            for where in ("cpu", "cuda"):
                argv = ["--arch", arch, "--steps", str(n_s), "--batch",
                        str(Bs), "--seq", str(Ss), "--ckpt-every",
                        str(DRIVER_EVERY), "--log-every", "1", "--device",
                        where, "--ckpt-dir", str(ckroot / "c" / where)]
                attrs = {"get_arch": lambda a: entry}
                if where == "cuda":
                    # the CPU's weights, moved to the card
                    attrs["make_params"] = (
                        lambda c, seed, d: make_params(c, seed, "cpu").to(d))
                    attrs["make_train_step"] = counting(
                        f"driver_smoke_{arch}", per_c)
                with mock.patch.multiple(T, **attrs):
                    runs[where] = driver(argv, io.StringIO())
            lc = [h.loss for h in runs["cpu"].loop.history]
            lg = [h.loss for h in runs["cuda"].loop.history]
            loss_d = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
            steps_c = runs["cpu"].ckpt.steps()
            worst = 0.0
            for st in steps_c:
                d = {w: ckroot / "c" / w / scfg.name / f"step_{st:08d}"
                     for w in ("cpu", "cuda")}
                man = {w: json.loads((d[w] / "manifest.json").read_text())
                       for w in d}
                check(man["cpu"]["leaves"].keys()
                      == man["cuda"]["leaves"].keys(),
                      f"{arch}: the same leaves on CPU and card")
                for name, meta in man["cpu"]["leaves"].items():
                    a = np.load(d["cpu"] / meta["file"])
                    b = np.load(d["cuda"] / man["cuda"]["leaves"][name][
                        "file"])
                    scale = float(np.abs(a).max()) or 1.0
                    share = float(np.abs(a - b).max()) / scale
                    worst = max(worst, share)
                    check(share <= TRAIN_GRAD_TOL["float32"],
                          f"{arch} smoke, step {st}: leaf {name} "
                          f"{share:.2e} of its largest value apart")
            one = train_launches(scfg, TrainConfig(remat="none"), Ss)
            print(f"[19c] {arch} smoke (f32, {Bs} x {Ss}, {n_s} steps) "
                  f"through the driver, CPU vs card: losses "
                  f"{[round(v, 6) for v in lc]} / "
                  f"{[round(v, 6) for v in lg]} (within {loss_d:.2e}, "
                  f"relative); checkpoints {steps_c} / "
                  f"{runs['cuda'].ckpt.steps()}, leaves within "
                  f"{worst:.2e} of each leaf's largest value; card "
                  f"launches a step B4 {[c['rmsnorm'] for c in per_c]}, "
                  f"B5 {[c['ssd_chunk'] for c in per_c]} (want "
                  f"{one['rmsnorm']}, {one['ssd_chunk']})")
            check(loss_d <= TRAIN_LOSS_TOL["float32"],
                  f"{arch} smoke: losses on CPU and card")
            check(steps_c == runs["cuda"].ckpt.steps(),
                  f"{arch} smoke: the same steps checkpointed")
            check(all(c["rmsnorm"] == one["rmsnorm"]
                      and c["ssd_chunk"] == one["ssd_chunk"]
                      for c in per_c),
                  f"{arch} smoke: B4/B5 launched as its structure says")
            del runs

        # 19d. the five examples on the card
        root = Path(__file__).resolve().parent / "examples"
        for name in EXAMPLES:
            spec = importlib.util.spec_from_file_location(
                name, root / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            buf = io.StringIO()
            reset()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                out = mod.main(["--device", "cuda"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            now = read()
            add(f"example_{name}", now)
            lines = buf.getvalue().strip().splitlines()
            print(f"[19d] {name}.py --device cuda: {dt:.1f} s, launches "
                  f"{ {k: v for k, v in now.items() if v} }; its last "
                  f"lines:")
            for line in lines[-3:]:
                print(f"[19d]   {line}")
            if name == "torch_quickstart":
                check(out["losses"][-1] < out["losses"][0],
                      "quickstart: the loss falls")
                check(now["rmsnorm"] > 0, "quickstart launched B4")
            elif name == "torch_lqcd_cg":
                check(max(out["err_full"], out["err_eo"]) <= TOL,
                      "lqcd_cg: B1/B2 against their plain versions")
                check(out["plain"].converged and out["eo"].converged
                      and out["eo"].rel_residual <= 1e-6,
                      "lqcd_cg: both solves converge")
                check(now["dslash_eo_split"] > 0 and now["dslash_split"] > 0,
                      "lqcd_cg launched B1 and B2")
            elif name == "torch_green500_measurement":
                check(out["hpl"].passed and now["dgemm"] > 0,
                      "green500: the smoke Linpack passes through B3")
            elif name == "torch_efficient_serving":
                check(now["rmsnorm"] > 0, "efficient_serving launched B4")
        set_default_cache(None)
    finally:
        shutil.rmtree(ckroot, ignore_errors=True)
    for r in records:
        r["launches_by_driver_path"] = {k: own_launches(v, r["name"])
                                        for k, v in path.items()}
    t19 = time.perf_counter() - t19
    print(f"[19] phase 19 took {t19:.1f} s ({card})")
    return t19


def phase20(dev, card: str, records: list) -> float:
    """[20] The sharded LM path on one controller, a (2, 2) ``LMMesh`` of
    four coordinates on the one card: (a) hymba-1.5b at its published
    widths, prefill and greedy decode, every attention layer
    sequence-sharded, against ``mesh=None``; (b) its sharded train step
    against the one-device step, then a checkpoint of the shards restored
    onto (1, 4) and (1, 1) meshes; (c) grok-1-314b cut to 2 layers at full
    width through the "expert" plan and serve-EP decode, reported; (d)
    three smoke configurations' sharded forward, decode and train step on
    the CPU and the card.  Returns the phase's seconds."""
    import copy
    import dataclasses
    import shutil
    import statistics
    import tempfile

    import torch
    import torch.nn.functional as F

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import (ShapeConfig, TrainConfig, full_config,
                                    smoke_config)
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels.rmsnorm import kernel as RK
    from repro_torch.kernels.ssd_chunk import kernel as SK
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.serve import make_batch
    from repro_torch.models import init_params
    from repro_torch.models import moe as TMO
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.steps import (grow_decode_cache,
                                           make_decode_step,
                                           make_prefill_step,
                                           make_train_step)

    t20 = time.perf_counter()
    torch.cuda.empty_cache()
    path = {}                       # run -> {kernel: launches}
    f32 = torch.float32

    def counted(what, fn):
        """fn() with B4 and B5 counted from 0 (and added to the run's)."""
        RK.reset_launches()
        SK.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        now = {"rmsnorm": RK.LAUNCHES["rmsnorm"],
               "ssd_chunk": SK.LAUNCHES["ssd_chunk"]}
        run = path.setdefault(what, dict.fromkeys(now, 0))
        for k, v in now.items():
            run[k] += v
        return out, now

    def serve(cfg, params, batch, steps, mesh=None, feed=None, ep=False):
        """Prefill then ``steps`` decode steps (greedy, or fed ``feed``):
        (the logits (vocab tail cut, float32), the tokens, prefill s,
        decode s)."""
        mc = mesh.config if mesh is not None else None
        prefill = make_prefill_step(cfg, mesh=mesh, mesh_cfg=mc)
        decode = make_decode_step(cfg, mesh=mesh, mesh_cfg=mc,
                                  moe_ep_data=ep)
        V = cfg.vocab_size
        B, S = batch["tokens"].shape
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        cache = grow_decode_cache(cfg, cache, B, S + steps)
        out, toks = [logits[:, :V].float()], []
        t0 = time.perf_counter()
        for i in range(steps):
            tok = (feed[:, i:i + 1] if feed is not None
                   else torch.argmax(out[-1], -1)[:, None])
            toks.append(tok)
            logits, cache = decode(params, tok.to(logits.device,
                                                  torch.int32), cache)
            out.append(logits[:, :V].float())
        torch.cuda.synchronize()
        return out, torch.cat(toks, 1), t_pre, time.perf_counter() - t0

    def gap2(logits):
        top = torch.topk(logits, 2, -1).values
        return top[:, 0] - top[:, 1]

    def lm_batch(cfg, B, S, where):
        b = SyntheticLMData(cfg.vocab_size, S, B, seed=SEED).batch(0)
        return {k: torch.from_numpy(v).to(where) for k, v in b.items()}

    def sharded_state(cfg, params, mesh):
        """The parameters and zero AdamW moments placed under the train
        specs (each moment made whole one leaf at a time), the step count
        replicated."""
        sh = SH.named_shardings(mesh, SH.param_pspecs(cfg, params,
                                                      mesh.config))

        def zeros():
            return {k: SH.shard_tensor(torch.zeros(
                t.shape, dtype=f32, device=t.device), sh[k], copy=True)
                for k, t in params.named_parameters()}
        where = next(params.parameters()).device
        return SH.shard_tree(params, sh), {
            "m": zeros(), "v": zeros(),
            "step": SH.shard_tensor(torch.zeros((), dtype=torch.int32,
                                                device=where),
                                    SH.Sharding(mesh, SH.P()), copy=True)}

    mesh = make_smoke_mesh(*SHARD_MESH)
    check(mesh.distinct_devices == (torch.device("cuda", 0),)
          and mesh.size() == 4,
          "the (2, 2) mesh's four coordinates sit on cuda:0")

    # 20a. hymba-1.5b at its published widths, prefill and decode
    cfg = full_config(SHARD_ARCH)
    B, S, G = SHARD_SERVE
    check(cfg.n_heads % SHARD_MESH[1] != 0 and S % SHARD_MESH[1] == 0,
          "hymba's 25 heads do not divide the model axis, its prompt does: "
          "every attention layer takes the sequence-sharded path")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    batch = make_batch(cfg, B, S, dev)
    print(f"[20a] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, window "
          f"{cfg.sliding_window}, SSD chunk {cfg.ssm.chunk_size}, "
          f"{n_params} parameters ({cfg.dtype}), initialised in "
          f"{time.perf_counter() - t0:.2f} s; mesh {mesh.shape} "
          f"{mesh.axis_names} on {mesh.distinct_devices} ({card})")
    serve(cfg, params, {"tokens": batch["tokens"][:, :512]}, 2)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    (base, toks, pre0, dec0), n0 = counted(
        "hymba_mesh_none", lambda: serve(cfg, params, batch, G))
    peak0 = torch.cuda.max_memory_allocated() - held
    sh = SH.named_shardings(mesh, SH.param_pspecs(cfg, params, mesh.config,
                                                  mode="serve"))
    sparams = SH.shard_tree(params, sh)
    torch.cuda.synchronize()
    mesh.calls.clear()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    (shard, _, pre1, dec1), n1 = counted(
        "hymba_mesh_2x2", lambda: serve(cfg, sparams, batch, G, mesh=mesh,
                                        feed=toks))
    peak1 = torch.cuda.max_memory_allocated() - held
    traffic = dict(mesh.traffic)
    check(n1 == n0, f"B4/B5 launches on the mesh {n1} equal mesh=None's "
          f"{n0}: the shard bodies hold no kernel")
    check(n0 == {"rmsnorm": rmsnorms_per_forward(cfg) * (1 + G),
                 "ssd_chunk": ssd_chunks_per_prefill(cfg, S)},
          f"mesh=None's launches {n0} are the structure's")
    want_ag = (2 * cfg.n_layers * mesh.size() * (B // SHARD_MESH[0])
               * (S // SHARD_MESH[1]) * cfg.n_kv_heads * cfg.d_head * 2)
    check(traffic.get("all_gather", 0) == want_ag and set(traffic) ==
          {"all_gather"}, f"K/V gathered in every layer: {traffic}, want "
          f"all_gather {want_ag}")
    diffs, held_tok, agree_tok = [], 0, 0
    for a, b in zip(shard, base):
        torch.testing.assert_close(a, b, **LM_TOL)
        d = float((a - b).abs().max())
        diffs.append(d)
        wide = gap2(b) > 2 * d
        held_tok += int(wide.sum())
        agree_tok += int((torch.argmax(a, -1) == torch.argmax(b, -1))
                         [wide].sum())
    check(agree_tok == held_tok, f"the argmax agrees wherever mesh=None's "
          f"top-2 gap exceeds twice the step's max|dlogits| "
          f"({agree_tok} of {held_tok})")
    placed = sum(t.numel() * t.element_size() for st in sparams.values()
                 for t in {id(x): x for x in st.shards.values()}.values())
    print(f"[20a] {B} x {S} prompt + {G} greedy steps: mesh=None prefill "
          f"{pre0 * 1e3:.1f} ms, decode {dec0 / G * 1e3:.2f} ms/step, peak "
          f"{peak0 / 1e9:.2f} GB; on the (2, 2) mesh (fed mesh=None's "
          f"tokens) prefill {pre1 * 1e3:.1f} ms, decode "
          f"{dec1 / G * 1e3:.2f} ms/step, peak {peak1 / 1e9:.2f} GB beyond "
          f"the {placed / 1e9:.2f} GB of placed serve shards; collectives "
          f"{traffic} bytes; "
          f"max|dlogits| per step {[f'{d:.3g}' for d in diffs]} (held "
          f"within rtol = atol = {LM_TOL['rtol']}); argmax equal at "
          f"{agree_tok} of {held_tok} (row, step) pairs whose top-2 gap "
          f"is wider than twice that step's max|dlogits|, of "
          f"{B * (G + 1)}; B4 {n1['rmsnorm']}, B5 {n1['ssd_chunk']} "
          f"launches on both; tokens {toks[0, :8].tolist()} ({card})")
    del sparams, shard, base
    torch.cuda.empty_cache()

    # 20b. the sharded train step against the one-device step
    Bt, St, N = SHARD_TRAIN
    tc = TrainConfig(**SHARD_TC)
    want = train_launches(cfg, tc, St)
    tbatch = lm_batch(cfg, Bt, St, dev)
    runs = {}
    for kind in ("one_device", "mesh_2x2"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        mesh.calls.clear()
        if kind == "one_device":
            p = copy.deepcopy(params)
            o = adamw_init(p)
            b = tbatch
            step = make_train_step(cfg, tc)
        else:
            p, o = sharded_state(cfg, params, mesh)
            b = SH.shard_tree(tbatch, SH.named_shardings(
                mesh, SH.batch_pspecs(cfg, tbatch, mesh.config)))
            step = make_train_step(cfg, tc, mesh=mesh,
                                   mesh_cfg=mesh.config)
        losses, walls = [], []
        for i in range(N):
            t0 = time.perf_counter()
            (p, o, m), now = counted(f"hymba_train_{kind}",
                                     lambda: step(p, o, b))
            walls.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            check(now == want, f"[20b] {kind} step {i}: launches {now}, "
                  f"want {want}")
        runs[kind] = dict(losses=losses, walls=walls,
                          peak=torch.cuda.max_memory_allocated() - held,
                          traffic=dict(mesh.traffic))
        if kind == "one_device":
            del p, o
        else:
            sp, so = p, o
    for a, b in zip(runs["mesh_2x2"]["losses"], runs["one_device"]["losses"]):
        check(math.isfinite(a) and abs(a - b) <= SHARD_LOSS_TOL * abs(b),
              f"[20b] sharded loss {a} within {SHARD_LOSS_TOL} (relative) of "
              f"the one-device step's {b}")
    for kind, r in runs.items():
        print(f"[20b] {cfg.name} train step, {kind}: {Bt} x {St} in "
              f"{tc.microbatches} microbatches, remat {tc.remat!r}, lr "
              f"{tc.learning_rate}: losses {r['losses']}, step walls "
              f"{[round(w * 1e3, 1) for w in r['walls']]} ms (median "
              f"{statistics.median(r['walls']) * 1e3:.1f}), peak "
              f"{r['peak'] / 1e9:.2f} GB allocated beyond what the phase "
              f"held, collectives {r['traffic']} bytes; B4 "
              f"{want['rmsnorm']}, B5 {want['ssd_chunk']} launches a step "
              f"({card})")

    # 20b. the shards to disk, and back onto other meshes
    ckdir = Path(tempfile.mkdtemp(prefix="chip_smoke_shard_"))
    try:
        mgr = CheckpointManager(ckdir)
        t0 = time.perf_counter()
        mgr.save(N, sp, blocking=True)
        t_save = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in ckdir.rglob("*.npy"))
        whole = SH.unshard_tree(sp)
        for shape in ((1, 4), (1, 1)):
            other = SH.lm_mesh(shape, ("data", "model"))
            osh = SH.named_shardings(other, SH.param_pspecs(
                cfg, params, other.config))
            t0 = time.perf_counter()
            got = mgr.restore(N, sp, shardings=osh)
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
            same = all(
                got[k].mesh is other and got[k].dtype == whole[k].dtype
                and torch.equal(SH.unshard_tensor(got[k]), whole[k])
                and all(torch.equal(t, SH.shard_tensor(
                    whole[k], osh[k]).shards[c])
                        for c, t in got[k].shards.items())
                for k in whole)
            check(same, f"[20b] every leaf restored onto {shape} bit-equal")
            print(f"[20b] the {len(whole)} parameter leaves saved from the "
                  f"(2, 2) mesh ({nbytes / 1e9:.2f} GB on disk, save "
                  f"{t_save:.2f} s) restored onto a {shape} mesh in "
                  f"{t_restore:.2f} s, every shard bit-equal ({card})")
            del got
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    del sp, so, whole, params
    torch.cuda.empty_cache()

    # 20c. grok-1-314b cut to 2 layers at full width, reported
    L, Bg, Sg, Gg = SHARD_GROK
    cfg = dataclasses.replace(full_config("grok-1-314b"), n_layers=L)
    params = init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    batch = make_batch(cfg, Bg, Sg, dev)
    drops = []
    real_local = TMO._moe_local

    def dropping(cfg_, x2d, router_w, wg, wu, wd, off, n_local):
        """_moe_local, counting the (token, rank) pairs routed to this
        coordinate's experts that its capacity drops."""
        e = cfg_.moe
        idx = torch.topk(torch.softmax(x2d.float() @ router_w.float(), -1),
                         e.top_k, -1).indices
        local = (idx >= off) & (idx < off + n_local)
        flat = torch.where(local, idx - off, n_local).reshape(-1)
        onehot = F.one_hot(flat, n_local + 1)
        slot = torch.gather(torch.cumsum(onehot, 0) - onehot, 1,
                            flat[:, None])[:, 0]
        C = TMO._capacity(x2d.shape[0], cfg_, n_local)
        drops.append(int((local.reshape(-1) & (slot >= C)).sum()))
        return real_local(cfg_, x2d, router_w, wg, wu, wd, off, n_local)

    grok = {}
    TMO._moe_local = dropping
    try:
        for kind, m, ep in (("mesh_none", None, False),
                            ("mesh_2x2", mesh, True)):
            drops.clear()
            mesh.calls.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            feed = grok.get("mesh_none", {}).get("toks")
            (out, toks, pre, dec), n = counted(
                f"grok_cut_{kind}", lambda: serve(cfg, params, batch, Gg,
                                                  mesh=m, feed=feed, ep=ep))
            grok[kind] = dict(out=out, toks=toks, pre=pre, dec=dec,
                              drops=list(drops[:L * (mesh.size() if m
                                                     else 1)]),
                              peak=torch.cuda.max_memory_allocated() - held,
                              traffic=dict(mesh.traffic), launches=n)
    finally:
        TMO._moe_local = real_local
    check(grok["mesh_2x2"]["launches"] == grok["mesh_none"]["launches"],
          "[20c] B4 launches on the mesh equal mesh=None's")
    check(all(bool(torch.isfinite(t).all())
              for r in grok.values() for t in r["out"]),
          "[20c] grok's logits are finite on both")
    dl = [float((a - b).abs().max()) for a, b in
          zip(grok["mesh_2x2"]["out"], grok["mesh_none"]["out"])]
    for (kind, r), ep in zip(grok.items(), (False, True)):
        print(f"[20c] grok-1-314b cut to {L} layers at full width, "
              f"{kind}: prefill {Bg} x {Sg} {r['pre'] * 1e3:.1f} ms"
              f"{' (expert plan)' if ep else ''}, decode "
              f"{r['dec'] / Gg * 1e3:.2f} ms/step"
              f"{' (serve-EP, fed mesh=None tokens)' if ep else ''}, peak "
              f"{r['peak'] / 1e9:.2f} GB; prefill token-slots "
              f"dropped at capacity per layer x coordinate {r['drops']}; "
              f"collectives {r['traffic']} bytes; B4 "
              f"{r['launches']['rmsnorm']} ({card})")
    print(f"[20c] max|dlogits| from mesh=None per step (prefill first; "
          f"reported, not held: capacity is per shard) "
          f"{[f'{d:.4g}' for d in dl]} ({card})")
    del params, grok
    torch.cuda.empty_cache()

    # 20d. smoke configurations, CPU against card
    archs, Bs, Ss = SHARD_SMOKE
    for arch in archs:
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        p_cpu = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
        p_gpu = copy.deepcopy(p_cpu).to(dev)
        res = {}
        for where, p, m in (
                ("cpu", p_cpu, SH.lm_mesh(SHARD_MESH, ("data", "model"),
                                          devices=("cpu",))),
                ("card", p_gpu, make_smoke_mesh(*SHARD_MESH))):
            b = lm_batch(cfg, Bs, Ss, m.devices[0])
            out, toks, _, _ = serve(cfg, p, {"tokens": b["tokens"]}, 2,
                                    mesh=m, feed=res.get("cpu", {}).get(
                                        "toks"),
                                    ep=cfg.family == "moe")
            sp, so = sharded_state(cfg, p, m)
            step = make_train_step(cfg, TrainConfig(
                remat="block", microbatches=2, warmup_steps=1,
                learning_rate=1e-3), mesh=m, mesh_cfg=m.config)
            _, _, met = step(sp, so, SH.shard_tree(b, SH.named_shardings(
                m, SH.batch_pspecs(cfg, b, m.config))))
            res[where] = dict(out=[t.cpu() for t in out], toks=toks.cpu(),
                              loss=float(met["loss"]),
                              gnorm=float(met["grad_norm"]),
                              traffic=sum(m.traffic.values()))
        c, g = res["cpu"], res["card"]
        for a, b in zip(g["out"], c["out"]):
            torch.testing.assert_close(
                a, b, rtol=SHARD_SMOKE_TOL,
                atol=SHARD_SMOKE_TOL * float(b.abs().max()))
        check(abs(g["loss"] - c["loss"]) <= SHARD_SMOKE_TOL * abs(c["loss"])
              and abs(g["gnorm"] - c["gnorm"]) <= 1e-3 * c["gnorm"]
              and g["traffic"] == c["traffic"] > 0,
              f"[20d] {arch}: the card's loss, grad norm and collective "
              f"bytes are the CPU's")
        dmax = max(float((a - b).abs().max())
                   for a, b in zip(g["out"], c["out"]))
        print(f"[20d] {arch} smoke (float32) on (2, 2) meshes: prefill + 2 "
              f"decode steps{' (serve-EP)' if cfg.family == 'moe' else ''}"
              f", max|dlogits| card - CPU {dmax:.3g}; one sharded train "
              f"step (remat 'block', 2 microbatches) "
              f"loss {g['loss']:.6f} / {c['loss']:.6f}, grad norm "
              f"{g['gnorm']:.6f} / {c['gnorm']:.6f}; {g['traffic']} "
              f"collective bytes on both ({card})")
    for r in records:
        r["launches_by_sharded_path"] = {k: own_launches(v, r["name"])
                                         for k, v in path.items()}
    t20 = time.perf_counter() - t20
    print(f"[20] phase 20 took {t20:.1f} s ({card})")
    return t20



def phase21(dev, card: str, records: list) -> float:
    """[21] The multi-pod dry run (``launch.dryrun``) on ``meta`` tensors:
    (a) its CLI at full width on the production meshes (256 and 512
    coordinates), each record ``ok``, its
    roofline ``cost_for`` of its plan at the H100's rates, the records
    rendered by ``roofline.report``, into a temporary directory the phase
    deletes; (b) two cells traced on a one-device mesh and run on the card
    from the same shapes: B4/B5 launches equal to the trace's calls, the
    card's peak memory within DRYRUN_PEAK_TOL of the record's
    ``total_hbm_bytes``, the walls beside ``step_lower_bound_s``.  Returns
    the phase's seconds."""
    import shutil
    import tempfile

    import torch

    from repro_torch.config import (SHAPES, MeshConfig, ShapeConfig,
                                    TrainConfig, full_config)
    from repro_torch.distributed.sharding import lm_mesh
    from repro_torch.kernels.rmsnorm import kernel as RK
    from repro_torch.kernels.ssd_chunk import kernel as SK
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import mesh_config
    from repro_torch.power.model import H100_SXM
    from repro_torch.roofline import report as REP
    from repro_torch.roofline.analytic import cost_for

    t21 = time.perf_counter()
    torch.cuda.empty_cache()
    GB = 1e9

    # (a) the CLI at full width on the production mesh
    out = Path(tempfile.mkdtemp(prefix="dryrun_torch_"))
    try:
        done = []

        def check_record(arch, shape_name, multi_pod):
            name = DR._cell_name(arch, shape_name, multi_pod, "baseline")
            rec = json.loads((out / f"{name}.json").read_text())
            check(rec["status"] == "ok", f"[21a] {name} is ok")
            cfg, shape = full_config(arch), SHAPES[shape_name]
            plan = rec["plan"]
            tc = (TrainConfig(**{k: plan[k] for k in (
                "microbatches", "moment_dtype", "grad_accum_dtype",
                "remat")}) if shape.kind == "train" else None)
            ac = cost_for(cfg, shape, mesh_config(multi_pod=multi_pod), tc,
                          serve_tp_only=plan["serve_tp_only"],
                          kv_int8=plan.get("kv_cache_int8", False),
                          moe_ep=plan["moe_ep_data"], chip=H100_SXM)
            r = rec["roofline"]
            check([r[k] for k in (
                "compute_s", "memory_s", "collective_s", "flops_per_chip",
                "hbm_bytes_per_chip", "ici_bytes_per_chip",
                "dcn_bytes_per_chip")] == [
                ac.compute_s, ac.memory_s, ac.collective_s, ac.flops,
                ac.hbm_bytes, ac.ici_bytes, ac.dcn_bytes],
                f"[21a] {name}: the roofline is cost_for of its plan at the "
                f"H100's rates")
            m, tr = rec["memory"], rec["traced"]
            print(f"[21a] {name} ({rec['n_devices']} coordinates on meta): "
                  f"plan {plan}; plan_s {rec['plan_s']}, trace_s "
                  f"{rec['trace_s']}; roofline compute {r['compute_s']:.6g} "
                  f"s, memory {r['memory_s']:.6g} s, collective "
                  f"{r['collective_s']:.6g} s ({r['dominant']}), useful "
                  f"{r['useful_ratio']:.4f}, fraction "
                  f"{r['roofline_fraction']:.4f}; traced per chip "
                  f"{tr['flops_per_chip']:.6g} FLOP, "
                  f"{tr['bytes_per_chip']:.6g} B, peak "
                  f"{tr['peak_bytes_per_chip'] / GB:.4f} GB, kernel calls "
                  f"{tr['kernel_calls_per_chip']}; memory "
                  f"{m['total_hbm_bytes'] / GB:.4f} GB a chip (fits "
                  f"{rec['fits_hbm']}); collectives of the "
                  f"{rec['collectives_scope']} {sorted(rec['collectives'])}")
            done.append(rec)

        for arch, shape_name, meshes in DRYRUN_CELLS:
            DR.main(["--arch", arch, "--shape", shape_name, "--out",
                     str(out)] + {("pod1",): [], ("pod2",): ["--multi-pod"],
                                  ("pod1", "pod2"): ["--both-meshes"]}[meshes])
            for mesh in meshes:
                check_record(arch, shape_name, mesh == "pod2")
        rows = [line for mesh in ("pod1", "pod2")
                for line in REP.markdown_table(
                    REP.load_cells(out, mesh=mesh)).splitlines()[2:]]
        check(len(rows) == len(done)
              and all("| ok |" in row for row in rows),
              "[21a] the report renders every record")
        print("[21a] " + REP.markdown_table([]).splitlines()[0])
        for row in rows:
            print("[21a] " + row)
    finally:
        shutil.rmtree(out, ignore_errors=True)

    # (b) the trace held against the card on a one-device mesh
    mc1 = MeshConfig((1, 1), ("data", "model"))
    checked = {}
    for arch, S, B, kind in DRYRUN_CARD:
        cfg = full_config(arch)
        shape = ShapeConfig(f"{kind}_{B}x{S}", S, B, kind)
        plan, tc = DR.plan_cell(cfg, shape, mc1)
        t0 = time.perf_counter()
        cost, mem = DR.trace_cell(
            cfg, shape, lm_mesh((1, 1), ("data", "model"),
                                devices=("meta",)),
            mc1, "baseline", plan, tc)
        t_trace = time.perf_counter() - t0
        roof = DR.roofline_record(cfg, shape, mc1, "baseline", plan, tc)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        step, args, _, _ = DR.cell_step(
            cfg, shape, lm_mesh((1, 1), ("data", "model"), devices=(dev,)),
            mc1, "baseline", plan, tc, device=dev)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() - base
        walls, peaks = [], []
        for _ in range(2):          # cold, then warm
            RK.reset_launches()
            SK.reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            result = step(*args)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated() - base)
            launches = {"rmsnorm": RK.LAUNCHES["rmsnorm"],
                        "ssd_chunk": SK.LAUNCHES["ssd_chunk"]}
            del result
        check(launches == cost.kernel_calls,
              f"[21b] {arch} {kind}: the card's B4/B5 launches {launches} "
              f"are the trace's calls {cost.kernel_calls}")
        total = mem["total_hbm_bytes"]
        err = max(abs(p - total) for p in peaks) / total
        print(f"[21b] {arch} {kind} {B} x {S} on a (1, 1) mesh, plan {plan}: "
              f"traced in {t_trace:.1f} s, B4/B5 {launches} on the card and "
              f"in the trace; arguments {mem['argument_size_in_bytes'] / GB:.4f}"
              f" GB traced, {resident / GB:.4f} GB resident on the card; "
              f"total_hbm_bytes {total / GB:.4f} GB (temp "
              f"{mem['temp_size_in_bytes'] / GB:.4f}, output "
              f"{mem['output_size_in_bytes'] / GB:.4f}, alias "
              f"{mem['alias_size_in_bytes'] / GB:.4f}) against the card's "
              f"peak {peaks[0] / GB:.4f} / {peaks[1] / GB:.4f} GB (cold / "
              f"warm; {100 * err:.2f}% off at most); wall "
              f"{walls[0] * 1e3:.2f} / {walls[1] * 1e3:.2f} ms beside "
              f"step_lower_bound_s {roof['step_lower_bound_s'] * 1e3:.4f} ms "
              f"({roof['dominant']}) ({card})")
        check(err <= DRYRUN_PEAK_TOL,
              f"[21b] {arch} {kind}: the card's peak within "
              f"{DRYRUN_PEAK_TOL:.0%} of the dry run's total_hbm_bytes")
        checked[f"{arch} {kind}"] = launches
        del step, args
        torch.cuda.empty_cache()
    for r in records:
        r["launches_by_dryrun_check"] = {k: own_launches(v, r["name"])
                                         for k, v in checked.items()}
    t21 = time.perf_counter() - t21
    print(f"[21] phase 21 took {t21:.1f} s ({card})")
    return t21



def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    import dataclasses

    from repro_torch import convert
    from repro_torch.cluster import HPLWorkload, LQCDSolveWorkload, run
    from repro_torch.config import full_config
    from repro_torch.configs.lcsc_lqcd import (EO_MIXED_SOLVER, PLAIN_SOLVER,
                                               THERMAL_LATTICE)
    from repro_torch.autotune import (EFFICIENCY_PERF_LOSS, MeasuredHPLModel,
                                      TuneCache, grid_search,
                                      hpl_blocking_space, set_default_cache,
                                      tune_dgemm_tiles, tune_hpl_blocking)
    from repro_torch.configs.hpl import DEFAULT_HPL, HPLConfig
    from repro_torch.hpl import blocked_lu, linpack_run, lu_solve
    from repro_torch.hpl import lu as TLU
    from repro_torch.kernels import _build
    from repro_torch.kernels.timing import bound, timed_ms
    from repro_torch.kernels.dgemm import kernel as G
    from repro_torch.kernels.dgemm import ops as GO
    from repro_torch.kernels.dgemm.ref import dgemm_ref, dgemm_update_ref_
    from repro_torch.kernels.dslash import kernel as K
    from repro_torch.kernels.panel import kernel as PK
    from repro_torch.kernels.dslash.ref import (dslash_eo_split_ref,
                                                dslash_split_ref, from_split,
                                                to_split)
    from repro_torch.kernels.rmsnorm import bench as RB
    from repro_torch.kernels.rmsnorm import kernel as RK
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssd_chunk import kernel as SK
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
    from repro_torch.configs.lcsc_lqcd import COLD_LATTICE
    from repro_torch.distributed import lattice_mesh
    from repro_torch.lqcd import (ShardedWilsonEO, dslash,
                                  dslash_flops_per_site, dslash_half, eo_pack,
                                  measured_lqcd_calibration, pack_gauge,
                                  schur_matvec, solve_dirac, su3_project)
    from repro_torch.lqcd.eo import (_round_complex, schur_composed,
                                     schur_matvec_dagger)
    from repro_torch.lqcd.multichip import dslash_sharded
    from repro_torch.lqcd.su3 import random_field_and_source
    from repro_torch.power import model as PM
    from repro_torch.roofline import hw
    from repro_torch.models import init_params
    from repro_torch.cluster import (CheckpointPolicy, ClusterTopology,
                                     simulate)
    from repro_torch.configs.lcsc_lqcd import SMOKE_LATTICE
    from repro_torch.distributed.fault import WeibullFailureModel
    from repro_torch.serve import (ContinuousBatchingEngine,
                                   ExecutedGroupRuntime, ServeCostModel,
                                   poisson_trace)
    from repro_torch.runtime.steps import (grow_decode_cache,
                                           make_decode_step,
                                           make_prefill_step)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    power_limit_w = float(smi.split(",")[-1].strip().split()[0])
    print(f"[1] card: {kind}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; TF32 off for matmul and cuDNN (the plain "
          f"versions must run in full f32)")

    # 2. build
    families = ("dslash", "dgemm", "rmsnorm", "ssd_chunk", "panel")
    t0 = time.perf_counter()
    _build.build(families)
    for mod in (K, G, RK, SK, PK):
        mod._lib()
    print(f"[2] built "
          f"{', '.join(_build.library_path(f).name for f in families)} in "
          f"{time.perf_counter() - t0:.2f} s")
    spills = []
    for family in families:
        func, spill = "", ""
        for line in _build.build_log(family).splitlines():
            if "Function properties for" in line:
                func = line.split("Function properties for")[-1].strip()
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                spill = m[0]
            if (m and ("gemm_kernel" in func or "rmsnorm_kernel" in func)
                    and (int(m[1]) or int(m[2]))):
                spills.append(f"{func}: {line.strip()}")
            if "registers" in line:
                # the kernel and its template arguments, as mangled
                name = re.sub(r"^_ZN?\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+", "",
                              func).split("EEv")[0]
                print(f"    ptxas ({family}) {name}: "
                      f"{line.split(':', 1)[-1].strip()}; {spill}")
    check(not spills, f"no spills in gemm_kernel or rmsnorm_kernel*: "
                      f"{spills}")

    rng = np.random.default_rng(SEED)

    def gauge(shape, device):
        m = (rng.standard_normal((4,) + shape + (3, 3))
             + 1j * rng.standard_normal((4,) + shape + (3, 3)))
        return su3_project(convert.gauge_from_numpy(m, device))

    def spinor(shape, device):
        return convert.spinor_from_numpy(
            rng.standard_normal(shape + (4, 3))
            + 1j * rng.standard_normal(shape + (4, 3)), device)

    # 3. kernels against their plain versions at the thermal shapes
    lat = THERMAL_LATTICE.shape
    U = gauge(lat, dev)
    psi = spinor(lat, dev)
    U_e, U_o = pack_gauge(U)
    err = {}
    U_s, psi_s = to_split(U), to_split(psi)
    got = K.dslash_split(U_s, psi_s)
    want = dslash_split_ref(U_s, psi_s)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    err["dslash_split"] = float((got - want).abs().max())
    eo_err = []
    for src_parity in (0, 1):
        U_out, U_src = (U_o, U_e) if src_parity == 0 else (U_e, U_o)
        args = (to_split(U_out), to_split(U_src),
                to_split(eo_pack(psi, src_parity)), src_parity)
        got = K.dslash_eo_split(*args)
        want = dslash_eo_split_ref(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
        eo_err.append(float((got - want).abs().max()))
    err["dslash_eo_split"] = max(eo_err)
    print(f"[3] kernels vs plain at {lat}, rtol=atol={TOL}: dslash_split "
          f"max|err| {err['dslash_split']:.3e}; dslash_eo_split max|err| "
          f"{eo_err[0]:.3e} (even src), {eo_err[1]:.3e} (odd src)")
    # the fused Schur operator (B1 with a load transform and an epilogue)
    # against the plain hops and torch passes it replaced, bit for bit
    psi_e = eo_pack(psi, 0)
    fused_err = []
    for inner in (None, torch.bfloat16):
        U_e_lo, U_o_lo = (_round_complex(h, inner) for h in (U_e, U_o))
        for dagger in (False, True):
            got = from_split(K.schur_eo_split(
                to_split(U_e_lo), to_split(U_o_lo), to_split(psi_e), KAPPA,
                dagger=dagger, inner_dtype=inner))
            want = schur_composed(U_e_lo, U_o_lo, psi_e, KAPPA,
                                  dagger=dagger, inner_dtype=inner)
            check(torch.equal(got, want), f"the fused Schur operator "
                  f"(dagger {dagger}, inner {inner}) equals the plain "
                  f"hops' composition bit for bit")
            fused_err.append(float((got - want).abs().max()))
    err["dslash_eo_fused"] = max(fused_err)
    print(f"[3] fused Schur operator (schur_eo_split) vs the plain hops' "
          f"composition at {lat}, inner None and bf16, dagger or not: "
          f"bit-equal")

    # 4. the main path: even-odd mixed-precision solve
    rhs = [spinor(lat, dev) for _ in range(N_RHS)]
    torch.cuda.synchronize()
    K.reset_launches()
    results = []
    for b in rhs:
        t0 = time.perf_counter()
        res = solve_dirac(U, b, KAPPA, EO_MIXED_SOLVER)
        torch.cuda.synchronize()
        results.append((res, time.perf_counter() - t0))
    launches = dict(K.LAUNCHES)
    inner_total = 0
    for k, (res, wall) in enumerate(results):
        print(f"[4] EO_MIXED_SOLVER rhs {k}: {res.iters} inner normal ops + "
              f"{res.outer_iters} outer, true rel. residual "
              f"{res.rel_residual:.3e}, converged {res.converged}, "
              f"{wall * 1e3:.1f} ms wall")
        check(res.converged and res.rel_residual <= 1e-6,
              f"rhs {k} converged to rel. residual <= 1e-6")
        check(tuple(res.x.shape) == lat + (4, 3)
              and bool(torch.isfinite(torch.view_as_real(res.x)).all()),
              f"rhs {k} solution finite, of shape {lat + (4, 3)}")
        inner_total += res.iters
    outer_total = sum(res.outer_iters for res, _ in results)
    print(f"[4] launches on the main path: {launches}")
    check(launches["dslash_eo_split"] >= 4 * inner_total,
          "dslash_eo_split launched >= 4 x inner iterations")
    check(launches["dslash_eo_fused"] == 4 * (inner_total + outer_total),
          "the fused Schur operator launched 4 x (inner + outer) hops")
    check(launches["dslash_split"] >= 1, "dslash_split launched")
    # the residual again, through the plain full hop instead of the kernel
    for k, ((res, _), b) in enumerate(zip(results, rhs)):
        mx = res.x - KAPPA * torch.view_as_complex(
            dslash_split_ref(U_s, to_split(res.x)))
        rel = float(torch.linalg.vector_norm(b - mx)
                    / torch.linalg.vector_norm(b))
        print(f"[4] rhs {k}: rel. residual through the plain D-slash "
              f"{rel:.3e}")
        # the two hops sum in other orders: the residual moves by ~1e-7
        check(rel <= 2e-6, f"rhs {k} plain-path residual <= 2e-6")
    # small lattice: the kernels' solve against the plain versions' on CPU
    small = (8, 8, 8, 8)
    U_c = gauge(small, "cpu")
    b_c = spinor(small, "cpu")
    r_cpu = solve_dirac(U_c, b_c, KAPPA, EO_MIXED_SOLVER)
    r_gpu = solve_dirac(U_c.to(dev), b_c.to(dev), KAPPA, EO_MIXED_SOLVER)
    dx = float((r_gpu.x.cpu() - r_cpu.x).abs().max())
    print(f"[4] {small} CPU plain vs card kernels: iters {r_cpu.iters}+"
          f"{r_cpu.outer_iters} vs {r_gpu.iters}+{r_gpu.outer_iters}, "
          f"max|dx| {dx:.2e}")
    check(r_cpu.converged and r_gpu.converged, "small solves converged")
    check(abs(r_cpu.iters - r_gpu.iters) <= 2 and dx <= 2e-4,
          "small solve on the card agrees with the CPU")

    # 5. plain CGNE: the full-lattice kernel in every iteration
    b = rhs[0]
    K.reset_launches()
    t0 = time.perf_counter()
    res = solve_dirac(U, b, KAPPA, PLAIN_SOLVER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"[5] PLAIN_SOLVER: {res.iters} normal ops, true rel. residual "
          f"{res.rel_residual:.3e}, converged {res.converged}, "
          f"{wall * 1e3:.1f} ms wall, launches {dict(K.LAUNCHES)}")
    check(res.converged, "plain solve converged")
    check(K.LAUNCHES["dslash_split"] >= 2 * res.iters,
          "dslash_split launched >= 2 x plain normal ops")

    # 6. timing at the thermal shapes
    records = []
    psi_h = to_split(eo_pack(psi, 0))
    eo_args = (to_split(U_o), to_split(U_e), psi_h, 0)
    cases = [
        ("dslash_eo_split", lambda: K.dslash_eo_split(*eo_args),
         lambda: dslash_eo_split_ref(*eo_args),
         [eo_args[0], eo_args[1], psi_h, psi_h], psi_h.shape[:4].numel()),
        ("dslash_split", lambda: K.dslash_split(U_s, psi_s),
         lambda: dslash_split_ref(U_s, psi_s),
         [U_s, psi_s, psi_s], psi_s.shape[:4].numel()),
    ]
    for name, kern, plain, in_out, sites in cases:
        ms = timed_ms(kern, reps=200, warmup=20)
        plain_ms = timed_ms(plain, reps=5, warmup=2, host_paced_ok=True)
        b_ms, b_by = bound(in_out, sites, dslash_flops_per_site())
        nbytes = sum(t.numel() * t.element_size() for t in in_out)
        print(f"[6] {name}: {ms * 1e3:.1f} us, {nbytes / ms / 1e6:.0f} GB/s, "
              f"{100 * b_ms / ms:.1f}% of the {b_ms * 1e3:.1f} us "
              f"{b_by} bound; plain {plain_ms:.3f} ms; library_ms: n/a "
              f"(no PyTorch call computes D-slash)")
        records.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": own_launches(launches, name),
                        "max_abs_err": err[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None})

    # 6b. the fused Schur operator's hops and its A^+A beside the bytes
    # bound (768 B an output half-site for a plain or load-transform hop,
    # 864 B for an epilogue hop, which reads psi too) and beside the
    # unfused chain it replaced (plain hops, torch's rounding, gamma5 and
    # axpy passes), on a bf16-rounded gauge field, at the thermal and the
    # cold lattice (there a hop's operands exceed the L2 cache)
    fused = {}
    for where, shape in (("32^3x8", lat), ("32^3x64", COLD_LATTICE.shape)):
        U_f, b_f = random_field_and_source(shape, SEED, dev)
        U_fe, U_fo = (_round_complex(h, torch.bfloat16)
                      for h in pack_gauge(U_f))
        v = eo_pack(b_f, 0)
        Ue_s, Uo_s, v_s = to_split(U_fe), to_split(U_fo), to_split(v)
        shape_h, dev_h = tuple(v.shape[:4]), v.device   # with its index
        d_s = K.dslash_eo_split(Uo_s, Ue_s, v_s, 0)  # an epilogue's source
        out_s = torch.empty_like(v_s)
        del U_f, b_f

        def hop(epi=False, **kw):
            if epi:     # odd -> even, psi read at the output site
                return lambda: K._eo_launch(
                    Ue_s, Uo_s, d_s, out_s, shape_h, 0, dev_h, psi_epi=v_s,
                    k2=KAPPA * KAPPA, epi=True, **kw)
            return lambda: K._eo_launch(Uo_s, Ue_s, v_s, out_s, shape_h, 1,
                                        dev_h, **kw)

        def normal_fused():
            av = K.schur_eo_split(Ue_s, Uo_s, v_s, KAPPA,
                                  inner_dtype=torch.bfloat16)
            K.schur_eo_split(Ue_s, Uo_s, av, KAPPA, dagger=True,
                             inner_dtype=torch.bfloat16)

        def normal_unfused():
            av = schur_composed(U_fe, U_fo, v, KAPPA,
                                inner_dtype=torch.bfloat16)
            schur_composed(U_fe, U_fo, av, KAPPA, dagger=True,
                           inner_dtype=torch.bfloat16)

        half_sites = v.numel() // 12
        hop_b, epi_b = (half_sites * n / hw.HBM_BW * 1e3
                        for n in (768, 864))
        rows = {"hop, plain": (hop(), hop_b),
                "hop, bf16 rounding on load": (hop(rnd=1), hop_b),
                "hop, gamma5 on load": (hop(g5=True), hop_b),
                "hop, epilogue, bf16": (hop(rnd=1, epi=True), epi_b),
                "hop, epilogue, gamma5 + bf16":
                    (hop(rnd=1, g5=True, epi=True), epi_b),
                "A^+A, fused (4 launches)":
                    (normal_fused, 2 * (hop_b + epi_b)),
                "A^+A, unfused chain (16 launches)":
                    (normal_unfused, 2 * (hop_b + epi_b))}
        fused[where] = {}
        for what, (fn, b_ms) in rows.items():
            ms = timed_ms(fn, reps=50 if what.startswith("hop") else 20,
                          warmup=5)
            fused[where][what] = {"ms": ms, "bound_ms": b_ms}
            print(f"[6] {where} {what}: {ms * 1e3:.1f} us, "
                  f"{100 * b_ms / ms:.1f}% of the {b_ms * 1e3:.1f} us bytes "
                  f"bound")
        del U_fe, U_fo, v, Ue_s, Uo_s, v_s, d_s, out_s
    torch.cuda.empty_cache()
    thermal = fused["32^3x8"]
    records.append({
        "name": "dslash_eo_fused", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["dslash_eo_fused"],
        "launches": launches["dslash_eo_fused"],
        "max_abs_err": err["dslash_eo_fused"],
        "ms": thermal["A^+A, fused (4 launches)"]["ms"],
        "plain_ms": thermal["A^+A, unfused chain (16 launches)"]["ms"],
        "bound_ms": thermal["A^+A, fused (4 launches)"]["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "what": "one A^+A of the inner CG (bf16); plain_ms is the unfused "
                "chain it replaced", "by_lattice": fused})

    # 7. the GEMM kernel against its plain version on the card
    gen = torch.Generator(dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    gemm_tol = {torch.float32: dict(rtol=2e-5, atol=1e-3),
                torch.bfloat16: dict(rtol=0.1, atol=0.1)}
    for m, n, k in GEMM_SWEEP + [GEMM_RAGGED]:
        for dtype in (torch.float32, torch.bfloat16):
            x, y, c = randn(m, k, dtype=dtype), randn(k, n, dtype=dtype), \
                randn(m, n, dtype=dtype)
            got, want = G.dgemm(x, y), dgemm_ref(x, y)
            want_c = dgemm_update_ref_(c.clone(), x, y)
            G.dgemm_update_(c, x, y)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **gemm_tol[dtype])
            torch.testing.assert_close(c, want_c, **gemm_tol[dtype])
    # strided views whose window starts off the 16-byte grid
    a = randn(1024, 1024)
    got, want = a.clone(), a.clone()
    for t, fn in ((got, G.dgemm_update_), (want, dgemm_update_ref_)):
        fn(t[131:, 131:], t[131:, 3:131], t[3:131, 131:])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **gemm_tol[torch.float32])
    print(f"[7] dgemm and dgemm_update_ vs plain: {GEMM_SWEEP} and ragged "
          f"{GEMM_RAGGED} in f32 (rtol 2e-5, atol 1e-3) and bf16 (0.1), "
          f"unaligned views of a 1024^2 matrix: all within tolerance")

    def step0(t, fn, split):
        """HPL's step-0 trailing update on views of the n x n matrix t:
        the main path's two calls (next panel, rest), or one."""
        l21, u12, a22 = t[HPL_NB:, :HPL_NB], t[:HPL_NB, HPL_NB:], \
            t[HPL_NB:, HPL_NB:]
        if split:
            fn(a22[:, :HPL_NB], l21, u12[:, :HPL_NB])
            fn(a22[:, HPL_NB:], l21, u12[:, HPL_NB:])
        else:
            fn(a22, l21, u12)

    a_big = randn(HPL_N, HPL_N)
    a_plain = a_big.clone()
    gemm_errs = []
    for split in (True, False):
        before = a_big[HPL_NB:, HPL_NB:].abs().sum()
        step0(a_big, G.dgemm_update_, split)
        step0(a_plain, dgemm_update_ref_, split)
        torch.cuda.synchronize()
        check(bool(a_big[HPL_NB:, HPL_NB:].abs().sum() != before),
              "the step-0 update changed the trailing window")
        torch.testing.assert_close(a_big, a_plain, **gemm_tol[torch.float32])
        gemm_errs.append(float((a_big - a_plain).abs().max()))
    err["dgemm"] = max(gemm_errs)
    del a_plain
    print(f"[7] HPL step-0 update at n={HPL_N}, nb={HPL_NB} (f32 views, "
          f"ld={HPL_N}): max|err| {gemm_errs[0]:.3e} (lookahead split), "
          f"{gemm_errs[1]:.3e} (one call)")

    # 8. the HPL path at full size
    torch.cuda.empty_cache()
    cfg = HPLConfig(n=HPL_N, block=HPL_NB, lookahead=HPL_LOOKAHEAD)
    steps = cfg.n // cfg.block
    # each step but the last updates the next panel; all but the last two
    # also update the rest
    expect = (steps - 1) + (steps - 2) if cfg.lookahead else steps - 1
    torch.cuda.synchronize()
    K.reset_launches()
    G.reset_launches()
    PK.reset_launches()
    t0 = time.perf_counter()
    res = linpack_run(cfg)
    total = time.perf_counter() - t0
    hpl_launches = {**K.LAUNCHES, **G.LAUNCHES, **PK.LAUNCHES}
    print(f"[8] linpack_run(n={cfg.n}, block={cfg.block}, lookahead="
          f"{cfg.lookahead}): scaled residual {res.residual:.4e}, passed "
          f"{res.passed}, factorization {res.wall_s:.3f} s, "
          f"{res.gflops:.1f} GFLOP/s (2/3 n^3), {total:.2f} s in all; "
          f"launches {hpl_launches}")
    check(res.passed, "HPL scaled residual < 16")
    check(hpl_launches["dgemm"] == expect
          and hpl_launches["dgemm_128x128"] == expect,
          f"dgemm launched {expect} times on the HPL path, all 128 x 128")
    check(hpl_launches["dslash_split"] == hpl_launches["dslash_eo_split"]
          == 0, "the HPL path launches no D-slash")
    check(hpl_launches["panel_lu"] == hpl_launches["laswp"] == steps,
          f"the panel and swap kernels launched {steps} times each")
    del a_big
    torch.cuda.empty_cache()
    # one matrix on the CPU (plain) and on the card (kernel).  Seed 20's
    # closest pivot choice is a relative gap of 4.8e-4 (the widest of the
    # 60 seeds checked), above the rounding differences of two devices.
    # The factors are held normwise at 1e-3: on one CPU, the JAX package's
    # and the port's LU at n = 1024 differ by up to 1.0e-4 of max|lu| and
    # 2.9e-4 of max|x|, since the two sum in other orders.
    small = DEFAULT_HPL
    rng_small = np.random.default_rng(SMALL_HPL_SEED)
    a_c = convert.matrix_from_numpy(
        rng_small.standard_normal((small.n, small.n)), "cpu")
    b_c = torch.from_numpy(rng_small.standard_normal(small.n)
                           .astype(np.float32))
    r_cpu = blocked_lu(a_c, small.block, lookahead=small.lookahead)
    x_cpu = lu_solve(r_cpu, b_c, small.block)
    r_gpu = blocked_lu(a_c.to(dev), small.block, lookahead=small.lookahead)
    x_gpu = lu_solve(r_gpu, b_c.to(dev), small.block).cpu()
    dlu = float((r_gpu.lu.cpu() - r_cpu.lu).abs().max()
                / r_cpu.lu.abs().max())
    dx = float((x_gpu - x_cpu).abs().max() / x_cpu.abs().max())
    same_piv = torch.equal(r_gpu.piv.cpu(), r_cpu.piv)
    print(f"[8] n={small.n}, block={small.block}: CPU plain vs card kernel: "
          f"pivots equal {same_piv}, max|dlu|/max|lu| {dlu:.2e}, "
          f"max|dx|/max|x| {dx:.2e}")
    check(same_piv, "pivots equal on the CPU and the card")
    check(dlu <= 1e-3 and dx <= 1e-3, "LU and x agree to 1e-3 normwise")
    t0 = time.perf_counter()
    hpl_profile(blocked_lu, randn(HPL_PROFILE_N, HPL_PROFILE_N))
    print(f"[8] the profiled phase took {time.perf_counter() - t0:.1f} s")

    # 8b. the panel kernels against their plain versions at the path's
    # shapes: the panel of an HPL_N x HPL_N matrix at k0 = 0 and n / 2
    a_big = randn(HPL_N, HPL_N)
    panel_rec = {"panel_lu": {}, "laswp": {}}
    for k0 in (0, HPL_N // 2):
        k1, m = k0 + HPL_NB, HPL_N - k0
        got, want = a_big.clone(), a_big.clone()
        gp = torch.empty(HPL_NB, dtype=torch.int32, device=dev)
        wp = torch.empty_like(gp)
        PK.panel_lu_(got, k0, HPL_NB, gp)
        TLU._panel_factor(want, k0, HPL_NB, wp)
        torch.cuda.synchronize()
        diff = float((got[k0:, k0:k1] - want[k0:, k0:k1]).abs().max())
        rel = diff / float(want[k0:, k0:k1].abs().max())
        panel_only = got.clone()
        panel_only[k0:, k0:k1] = a_big[k0:, k0:k1]
        check(torch.equal(gp, wp), f"[8b] k0 = {k0}: the panel kernel's "
              f"pivots equal the plain panel's")
        check(rel <= PANEL_NORMWISE, f"[8b] k0 = {k0}: the panel within "
              f"{PANEL_NORMWISE:.0e} of max|lu| of the plain panel's")
        check(torch.equal(panel_only, a_big),
              f"[8b] k0 = {k0}: the panel kernel wrote only the panel")
        del panel_only
        # the swaps on the other columns, bit for bit
        swapped = got.clone()
        PK.laswp_(swapped, k0, HPL_NB, gp)
        TLU._swap_rest(got, k0, HPL_NB, gp)
        torch.cuda.synchronize()
        check(torch.equal(swapped, got), f"[8b] k0 = {k0}: laswp_ equals "
              f"the plain swaps bit for bit")
        perm = list(range(HPL_N))
        for j, p in enumerate(gp.tolist()):
            perm[k0 + j], perm[p] = perm[p], perm[k0 + j]
        moved = sum(i != r for i, r in enumerate(perm))
        check(moved > 0, f"[8b] k0 = {k0}: the swaps moved rows")
        del swapped, got
        # times: each factorization on the unfactored panel, put back before
        # every call (that copy's time taken apart and subtracted), so
        # that it finds the pivots above; the swaps again with those pivots
        panel, fresh = want[k0:, k0:k1], a_big[k0:, k0:k1]
        tp = torch.empty_like(gp)
        copy_ms = timed_ms(lambda: panel.copy_(fresh), reps=20, warmup=2)
        ms = timed_ms(lambda: (panel.copy_(fresh),
                               PK.panel_lu_(want, k0, HPL_NB, tp)),
                      reps=20, warmup=2) - copy_ms
        check(torch.equal(tp, gp), f"[8b] k0 = {k0}: the timed panel kernel "
              f"found the same pivots")
        plain_ms = timed_ms(lambda: (panel.copy_(fresh),
                                     TLU._panel_factor(want, k0, HPL_NB, tp)),
                            reps=2, warmup=1, host_paced_ok=True) - copy_ms
        flops = sum((m - j - 1) * (1 + 2 * (HPL_NB - j - 1))
                    for j in range(HPL_NB))
        b_ms, b_by = bound([panel, panel], flops, 1)
        panel_rec["panel_lu"][k0] = {
            "shape": [m, HPL_NB], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": diff,
            "normwise_err": rel}
        print(f"[8b] panel_lu_ at k0 = {k0} ({m} x {HPL_NB} of {HPL_N}^2): "
              f"pivots equal, max|dlu| {diff:.3e} ({rel:.2e} of max|lu|); "
              f"{ms:.3f} ms, {100 * b_ms / ms:.1f}% of the {b_ms:.4f} ms "
              f"{b_by} bound; plain {plain_ms:.1f} ms")
        ms = timed_ms(lambda: PK.laswp_(want, k0, HPL_NB, gp), reps=20,
                      warmup=2)
        plain_ms = timed_ms(lambda: TLU._swap_rest(want, k0, HPL_NB, gp),
                            reps=2, warmup=1, host_paced_ok=True)
        nbytes = 2 * moved * (HPL_N - HPL_NB) * want.element_size()
        b_ms = nbytes / hw.HBM_BW * 1e3
        panel_rec["laswp"][k0] = {
            "rows_moved": moved, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": "bytes", "max_abs_err": 0.0}
        print(f"[8b] laswp_ at k0 = {k0}: bit-equal to the plain swaps; "
              f"{moved} rows moved over {HPL_N - HPL_NB} columns, "
              f"{ms * 1e3:.1f} us, {100 * b_ms / ms:.1f}% of the "
              f"{b_ms * 1e3:.1f} us bytes bound; plain {plain_ms:.1f} ms")
        del want
    del a_big
    torch.cuda.empty_cache()
    for name, by_k0 in panel_rec.items():
        first = by_k0[0]
        records.append({"name": name, "route": "cuda",
                        "source": PANEL_SOURCE, "replaces": None,
                        "launches": hpl_launches[name],
                        "max_abs_err": max(r["max_abs_err"]
                                           for r in by_k0.values()),
                        "ms": first["ms"], "plain_ms": first["plain_ms"],
                        "bound_ms": first["bound_ms"],
                        "bound_by": first["bound_by"], "library_ms": None,
                        "shapes": {f"k0={k0}": r for k0, r in by_k0.items()}})

    # 9. the time of step 0's larger update (the rest, after the next
    # panel's columns) at full size, on views of the n x n matrix
    a_big = randn(HPL_N, HPL_N)
    l21, u12, a22 = a_big[HPL_NB:, :HPL_NB], \
        a_big[:HPL_NB, 2 * HPL_NB:], a_big[HPL_NB:, 2 * HPL_NB:]
    ms = timed_ms(lambda: G.dgemm_update_(a22, l21, u12), reps=10, warmup=2)
    plain_ms = timed_ms(lambda: dgemm_update_ref_(a22, l21, u12), reps=3,
                        warmup=1, host_paced_ok=True)
    library_ms = timed_ms(lambda: a22.addmm_(l21, u12, alpha=-1), reps=10,
                          warmup=2)
    matmul_ms = timed_ms(lambda: torch.matmul(l21, u12), reps=10, warmup=2)
    m, n = a22.shape
    flops = 2 * m * n * HPL_NB
    b_ms, b_by = bound([l21, u12, a22, a22], flops, 1)
    print(f"[9] dgemm_update_ at ({m},{HPL_NB})@({HPL_NB},{n}): "
          f"{ms:.3f} ms, {flops / ms / 1e9:.2f} TFLOP/s, "
          f"{100 * b_ms / ms:.1f}% of the {b_ms:.3f} ms {b_by} bound; "
          f"plain (matmul, then sub_) {plain_ms:.3f} ms; library "
          f"a22.addmm_(l21, u12, alpha=-1) {library_ms:.3f} ms; "
          f"torch.matmul(l21, u12) alone {matmul_ms:.3f} ms (TF32 off)")
    records.append({"name": "dgemm", "route": "cuda", "source": GEMM_SOURCE,
                    "replaces": GEMM_REPLACES,
                    "launches": hpl_launches["dgemm"],
                    "max_abs_err": err["dgemm"], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": library_ms})


    # 10. the LM kernels against their plain versions on the card
    del a_big, l21, u12, a22
    torch.cuda.empty_cache()
    cfg = full_config(ARCH)
    bf16 = torch.bfloat16
    rms_tol = {torch.float32: 1e-5, bf16: 0.05}
    for rows, d in RMS_SWEEP:
        for dtype in (torch.float32, bf16):
            x, w = randn(rows, d, dtype=dtype), randn(d, dtype=dtype)
            got, want = RK.rmsnorm(x, w), rmsnorm_ref(x, w)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=rms_tol[dtype],
                                       atol=rms_tol[dtype])
    # the path's shapes: the layer norms (bf16 x and scale over d_model)
    # and the gated norm (f32 x, bf16 scale over d_inner), B x S rows in
    # prefill and B rows in decode
    rms_shapes = RB.path_shapes(cfg.d_model, cfg.d_inner_ssm, cfg.n_layers,
                                SERVE_BATCH, SERVE_PROMPT, SERVE_GEN)
    rms_errs = RB.check_shapes({"kernel": RK.rmsnorm}, rms_shapes, SEED)
    err["rmsnorm"] = max(e["kernel"] for e in rms_errs.values())
    rms_variant = {k: RK.variant(randn(r, d, dtype=xdt),
                                 randn(d, dtype=wdt))[0]
                   for k, (r, d, xdt, wdt, _) in rms_shapes.items()}
    print(f"[10] rmsnorm vs plain: {RMS_SWEEP} in f32 (1e-5) and bf16 "
          f"(0.05) within tolerance; the path's shapes:")
    for k, (r, d, xdt, wdt, _) in rms_shapes.items():
        print(f"    {k} ({r}, {d}) x {xdt}, w {wdt}: kernel "
              f"{rms_variant[k]}, max|err| {rms_errs[k]['kernel']:.3e}")

    def ssd_inputs(B, Q, H, P, N, dtype, views=False):
        """test_ssd_chunk_sweep's distributions; with ``views``, x, B and
        C are slices of one conv output and dt a slice of a longer
        sequence, as the model passes them."""
        x, bm, cm = randn(B, Q, H * P), randn(B, Q, N), randn(B, Q, N)
        dt = torch.nn.functional.softplus(randn(B, 2 * Q, H))
        A, h = -torch.exp(randn(H) * 0.3), randn(B, H, P, N)
        conv = torch.cat([x, bm, cm], -1).to(dtype)
        if not views:
            conv = conv.clone()
            return (conv[..., :H * P].reshape(B, Q, H, P).contiguous(),
                    dt[:, :Q].contiguous(), A,
                    conv[..., H * P:H * P + N].contiguous(),
                    conv[..., H * P + N:].contiguous(), h)
        return (conv[..., :H * P].reshape(B, Q, H, P), dt[:, Q:], A,
                conv[..., H * P:H * P + N], conv[..., H * P + N:], h)

    for shape in SSD_SWEEP:
        for dtype in (torch.float32, bf16):
            args = ssd_inputs(*shape, dtype)
            (y, hn), (yr, hr) = SK.ssd_chunk(*args), ssd_chunk_ref(*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(y, yr, rtol=TOL, atol=TOL)
            torch.testing.assert_close(hn, hr, rtol=TOL, atol=TOL)
    sc = cfg.ssm
    ssd_shape = (SERVE_BATCH, sc.chunk_size, cfg.n_ssm_heads, sc.head_dim,
                 sc.d_state)
    # the wrapper's copy of the kernel's tiles and limits against the
    # library's own (the path's chunk, a long admitted one, refused ones)
    for qpn in (ssd_shape[1:2] + ssd_shape[3:], (4000, 128, 256),
                (8000, 128, 256), (30000, 8, 4), (16, 129, 4), (16, 8, 257)):
        for dtype in (torch.float32, bf16):
            check(SK.library_smem_bytes(*qpn, dtype)
                  == SK.admitted_smem_bytes(*qpn, dtype),
                  f"ssd_chunk shared memory and limits at (Q, P, N) = {qpn}, "
                  f"{dtype} agree with the library")
    ssd_args = ssd_inputs(*ssd_shape, bf16, views=True)
    (y, hn), (yr, hr) = SK.ssd_chunk(*ssd_args), ssd_chunk_ref(*ssd_args)
    torch.cuda.synchronize()
    # at Q = 256, N = 128 the f32 sums themselves are off an f64
    # evaluation by up to 6.6e-6 of max|y| (the plain version, CPU, same
    # distributions), so the absolute tolerance scales with max|y|
    for got, want in ((y, yr), (hn, hr)):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=TOL, atol=1e-5 * scale)
    err["ssd_chunk"] = max(float((y - yr).abs().max()),
                           float((hn - hr).abs().max()))
    print(f"[10] ssd_chunk vs plain: {SSD_SWEEP} in f32 and bf16 within "
          f"rtol = atol = {TOL}; the path's {ssd_shape} (bf16 x, B, C as "
          f"views): max|dy| {float((y - yr).abs().max()):.3e} of max|y| "
          f"{float(yr.abs().max()):.1f}, max|dh| "
          f"{float((hn - hr).abs().max()):.3e} of max|h| "
          f"{float(hr.abs().max()):.2f} (rtol {TOL}, atol 1e-5 max|.|)")

    # 11. the third path: serving mamba2-370m at its published widths
    V = cfg.vocab_size
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[11] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_ssm_heads} heads of {sc.head_dim}, d_state {sc.d_state}, "
          f"chunk {sc.chunk_size}, vocab {V} (padded {cfg.vocab_padded}), "
          f"{cfg.dtype}; {n_params} parameter elements "
          f"(param_count() {cfg.param_count()}), initialised in "
          f"{time.perf_counter() - t0:.2f} s")
    prompt = np.random.default_rng(SEED).integers(
        0, V, (SERVE_BATCH, SERVE_PROMPT))
    batch = {"tokens": torch.from_numpy(prompt).to(dev, torch.int32)}
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)

    def serve(gen):
        """Prefill, then ``gen`` greedy steps, as launch.serve does."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        cache = grow_decode_cache(cfg, cache, SERVE_BATCH,
                                  SERVE_PROMPT + gen)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        finite = torch.isfinite(logits).all()
        shape_ok = tuple(logits.shape) == (SERVE_BATCH, cfg.vocab_padded)
        toks = [torch.argmax(logits[:, :V], -1)[:, None]]
        t0 = time.perf_counter()
        for _ in range(gen):
            logits, cache = decode(params, toks[-1].to(torch.int32), cache)
            finite &= torch.isfinite(logits).all()
            toks.append(torch.argmax(logits[:, :V], -1)[:, None])
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        return (torch.cat(toks, 1), cache, bool(finite) and shape_ok,
                t_pre, t_dec)

    torch.cuda.synchronize()
    for mod in (K, G, RK, SK):
        mod.reset_launches()
    by_variant = RK.variant_launches()
    toks, cache, finite, t_pre, t_dec = serve(SERVE_GEN)
    lm_launches = {**K.LAUNCHES, **G.LAUNCHES, **RK.LAUNCHES, **SK.LAUNCHES}
    by_variant = {k: v - by_variant[k]
                  for k, v in RK.variant_launches().items()}
    by_shape = dict(RK.SHAPE_LAUNCHES)
    L = cfg.n_layers
    want_rms = (2 * L + 1) * (1 + SERVE_GEN)
    want_ssd = L * -(-SERVE_PROMPT // sc.chunk_size)
    print(f"[11] served {SERVE_BATCH} x {SERVE_PROMPT} prompt tokens, then "
          f"{SERVE_GEN} greedy steps (first call): prefill {t_pre * 1e3:.1f}"
          f" ms, decode {t_dec * 1e3:.1f} ms ({SERVE_GEN * SERVE_BATCH / t_dec:.1f}"
          f" tok/s); launches {lm_launches} (want rmsnorm {want_rms}, "
          f"ssd_chunk {want_ssd}); sample {toks[0, :16].tolist()}")
    check(finite, "logits finite, of shape (B, vocab_padded), every step")
    check(bool((toks < V).all()), f"greedy tokens < {V}")
    check(int(cache["pos"]) == SERVE_PROMPT + SERVE_GEN,
          f"pos == {SERVE_PROMPT + SERVE_GEN}")
    check(tuple(cache["ssm"].shape) == (L, SERVE_BATCH) + ssd_shape[2:]
          and cache["ssm"].dtype == torch.float32, "ssm cache layout")
    check(lm_launches["rmsnorm"] == want_rms,
          f"rmsnorm launched {want_rms} times (97 per forward)")
    # the launches at each path shape, counted by the wrapper in this run
    rms_launches = {k: by_shape.get((r, d, xdt), 0)
                    for k, (r, d, xdt, _, _) in rms_shapes.items()}
    print(f"[11] rmsnorm launches by shape: {rms_launches} (want "
          f"{ {k: s[-1] for k, s in rms_shapes.items()} }); by kernel "
          f"variant: {by_variant}")
    check(all(n == rms_shapes[k][-1] for k, n in rms_launches.items())
          and sum(rms_launches.values()) == lm_launches["rmsnorm"],
          "rmsnorm launched at the path's four shapes only, each as often "
          "as the model's layers and steps say")
    want_variant = dict.fromkeys(RK.VARIANTS, 0)
    for k, n in rms_launches.items():
        want_variant[rms_variant[k]] += n
    check(by_variant == want_variant, "each RMSNorm of the serve path ran "
          "the kernel variant its shape picks")
    check(lm_launches["ssd_chunk"] == want_ssd,
          f"ssd_chunk launched {want_ssd} times")
    check(lm_launches["dslash_split"] == lm_launches["dslash_eo_split"]
          == lm_launches["dgemm"] == 0, "the serve path launches no "
          "D-slash and no GEMM kernel")
    del cache

    # the model cut to 2 layers at full width, on the CPU (plain versions)
    # and on the card (kernels).  Seed 37's narrowest greedy choice (batch
    # 1, 9 choices) is a top-2 logit gap of 0.125 on the CPU, 4 bf16 ulps
    # at the logits' size (the widest of seeds 0-399, with 240, 244 and
    # 396; most seeds have a choice within one ulp, which rounding on
    # another device may flip).
    cut = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    p_cpu = init_params(cut, torch.Generator().manual_seed(CUT_SEED), "cpu")
    p_gpu = copy.deepcopy(p_cpu).to(dev)
    cut_prompt = torch.from_numpy(np.random.default_rng(CUT_SEED).integers(
        0, V, (1, CUT_PROMPT)))
    cut_prefill, cut_decode = make_prefill_step(cut), make_decode_step(cut)

    def greedy(p, tokens):
        logits, cache = cut_prefill(p, {"tokens": tokens})
        first, toks, gaps = logits, [], []
        for k in range(CUT_STEPS + 1):
            top = torch.topk(logits[:, :V].float(), 2, -1).values
            gaps.append(float((top[:, 0] - top[:, 1]).min()))
            toks.append(torch.argmax(logits[:, :V], -1)[:, None])
            if k < CUT_STEPS:
                logits, cache = cut_decode(p, toks[-1], cache)
        return (first[:, :V].float().cpu(), torch.cat(toks, 1).cpu(),
                min(gaps))

    first_c, toks_c, gap_c = greedy(p_cpu, cut_prompt)
    for mod in (RK, SK):
        mod.reset_launches()
    first_g, toks_g, gap_g = greedy(p_gpu, cut_prompt.to(dev))
    dlogit = float((first_g - first_c).abs().max())
    print(f"[11] {CUT_LAYERS} layers at full width, prompt {CUT_PROMPT}: "
          f"CPU plain vs card kernels: max|dlogits| after prefill "
          f"{dlogit:.4f} (of max|logit| {float(first_c.abs().max()):.3f}); "
          f"greedy tokens {toks_c[0].tolist()} (CPU) and "
          f"{toks_g[0].tolist()} (card); narrowest top-2 gap "
          f"{gap_c:.4f} (CPU), {gap_g:.4f} (card); card launches "
          f"{dict(RK.LAUNCHES)}, {dict(SK.LAUNCHES)}")
    check(RK.LAUNCHES["rmsnorm"] == (2 * CUT_LAYERS + 1) * (CUT_STEPS + 1)
          and SK.LAUNCHES["ssd_chunk"]
          == CUT_LAYERS * -(-CUT_PROMPT // sc.chunk_size),
          "the cut model on the card went through both kernels")
    check(torch.equal(toks_c, toks_g), "same greedy tokens on CPU and card")
    check(dlogit <= CUT_LOGIT_TOL,
          f"prefill logits agree within {CUT_LOGIT_TOL}")
    del p_gpu

    # 12. times: RMSNorm at its four path shapes, cold and warm, beside
    # the library; the share of the byte bound from the cold time
    rms_t = RB.time_shapes({"kernel": RK.rmsnorm, "library": RB.library},
                           rms_shapes, seed=SEED)
    rms_rec = {}
    for k, (r, d, xdt, wdt, _) in rms_shapes.items():
        t, n = rms_t[k], rms_launches[k]
        b_ms, b_by = t["bound_ms"], t["bound_by"]
        kc, kw = t["kernel"]["cold"], t["kernel"]["warm"]
        lc, lw = t["library"]["cold"], t["library"]["warm"]
        print(f"[12] rmsnorm {k} ({r}, {d}) x {xdt}, w {wdt}, "
              f"{rms_variant[k]}: cold {kc * 1e3:.2f} us "
              f"({100 * b_ms / kc:.1f}% of the {b_ms * 1e3:.3f} us {b_by} "
              f"bound; {t['sets']} sets), "
              f"warm {kw * 1e3:.2f} us; library F.rms_norm cold "
              f"{lc * 1e3:.2f} us ({100 * b_ms / lc:.1f}%), warm "
              f"{lw * 1e3:.2f} us; {n} launches in [11]'s serve run")
        check(b_ms <= kc and b_ms <= lc, f"rmsnorm {k}: cold times within "
              f"the byte bound (else the bound counts bytes wrongly)")
        rms_rec[k] = {"variant": rms_variant[k], "us_cold": kc * 1e3,
                      "us_warm": kw * 1e3, "library_us_cold": lc * 1e3,
                      "library_us_warm": lw * 1e3, "bound_us": b_ms * 1e3,
                      "bound_by": b_by, "launches": n}
    r, d, xdt, wdt, _ = rms_shapes["gated"]
    x, w = randn(r, d, dtype=xdt), randn(d, dtype=wdt)
    plain_ms = timed_ms(lambda: rmsnorm_ref(x, w), reps=10, warmup=2,
                        host_paced_ok=True)
    print(f"[12] rmsnorm plain version at the gated shape: "
          f"{plain_ms * 1e3:.1f} us")
    gated = rms_rec["gated"]
    records.append({"name": "rmsnorm", "route": "cuda", "source": RMS_SOURCE,
                    "replaces": RMS_REPLACES,
                    "launches": lm_launches["rmsnorm"],
                    "max_abs_err": err["rmsnorm"],
                    "ms": gated["us_warm"] / 1e3, "plain_ms": plain_ms,
                    "bound_ms": gated["bound_us"] / 1e3,
                    "bound_by": gated["bound_by"],
                    "library_ms": gated["library_us_warm"] / 1e3,
                    "shapes": rms_rec})
    del x, w
    Bb, Q, H, P, N = ssd_shape
    ms = timed_ms(lambda: SK.ssd_chunk(*ssd_args), reps=20, warmup=3)
    plain_ms = timed_ms(lambda: ssd_chunk_ref(*ssd_args), reps=5, warmup=1,
                        host_paced_ok=True)
    # the flops the function needs: the lower triangle (diagonal included)
    # of C B^T once per batch row (one group), exact on the bf16 tensor
    # cores when B and C are bf16; per (b, h) the lower triangle of the
    # scores times x and the two state terms, C h^T and x^T (B e^(..) dt),
    # whose f32 operands need the f32 rate
    cbt = Bb * Q * (Q + 1) * N
    per_head = Q * (Q + 1) * P + 4 * Q * P * N
    on_tc = ssd_args[3].dtype == bf16
    b_ms, b_by = bound(list(ssd_args) + [y, hn], 1,
                       Bb * H * per_head + (0 if on_tc else cbt),
                       bf16_tc_flops=cbt if on_tc else 0)
    needed = Bb * H * per_head + cbt
    full_square = Bb * H * (2 * Q * Q * N + 2 * Q * Q * P + 4 * Q * P * N)
    # with bf16 x, B and C the kernel runs each f32 product as three exact
    # bf16 products on the tensor cores: the least time for that work,
    # floored by the bytes, is the second bound; the share is taken
    # against the smaller of the two
    b2_ms, b2_by = bound(list(ssd_args) + [y, hn], 0, 0,
                         bf16_tc_flops=3 * Bb * H * per_head + cbt)
    print(f"[12] ssd_chunk {ssd_shape}: {ms * 1e3:.1f} us, "
          f"{needed / ms / 1e9:.2f} TFLOP/s of the {needed / 1e9:.3f} GFLOP "
          f"needed (C B^T {cbt / 1e9:.3f} GFLOP at the "
          f"{'bf16 tensor-core' if on_tc else 'f32'} rate, the rest "
          f"{Bb * H * per_head / 1e9:.3f} GFLOP at the f32 rate): "
          f"{100 * b_ms / ms:.1f}% of that {b_ms * 1e3:.1f} us {b_by} "
          f"bound; each f32 product as 3 bf16 tensor-core products "
          f"({(3 * Bb * H * per_head + cbt) / 1e9:.3f} GFLOP at 989 "
          f"TFLOP/s): {100 * b2_ms / ms:.1f}% of that {b2_ms * 1e3:.1f} us "
          f"{b2_by} bound; the TPU kernel's per-head full-square count "
          f"{full_square / 1e9:.3f} GFLOP would be "
          f"{full_square / hw.PEAK_F32_FLOPS * 1e6:.1f} us at the f32 rate; "
          f"plain {plain_ms:.3f} ms; library_ms: n/a (no PyTorch call "
          f"computes an SSD chunk)")
    if b2_ms < b_ms:
        b_ms, b_by = b2_ms, b2_by
    records.append({"name": "ssd_chunk", "route": "cuda",
                    "source": SSD_SOURCE, "replaces": SSD_REPLACES,
                    "launches": lm_launches["ssd_chunk"],
                    "max_abs_err": err["ssd_chunk"], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None})
    del ssd_args, y, hn, yr, hr
    _, _, _, t_pre, t_dec = serve(SERVE_GEN)
    print(f"[12] serve, second call: prefill {SERVE_BATCH} x {SERVE_PROMPT} "
          f"{t_pre * 1e3:.1f} ms ({SERVE_BATCH * SERVE_PROMPT / t_pre:.0f} "
          f"tok/s); decode {SERVE_GEN} steps x {SERVE_BATCH} "
          f"{t_dec * 1e3:.1f} ms ({t_dec / SERVE_GEN * 1e3:.2f} ms per step, "
          f"{SERVE_GEN * SERVE_BATCH / t_dec:.1f} tok/s); the weights' "
          f"{n_params * 2 / 1e9:.3f} GB read once per step is "
          f"{n_params * 2 / hw.HBM_BW * 1e3:.3f} ms at "
          f"{hw.HBM_BW / 1e12:.2f} TB/s")
    (logits, cache), wall, busy, count, order = device_activity(
        lambda: prefill(params, batch))
    print_activity(f"prefill {SERVE_BATCH} x {SERVE_PROMPT}", wall, busy,
                   count)
    for what, key in (("the SSD-chunk kernel", "ssd_chunk_kernel"),
                      ("the RMSNorm kernels", "rmsnorm_kernel")):
        k_busy = sum(v for k, v in busy.items() if key in k)
        k_count = sum(v for k, v in count.items() if key in k)
        print(f"[12] {what} in that prefill: {k_busy * 1e3:.3f} ms in "
              f"{k_count} launches, {100 * k_busy / sum(busy.values()):.1f}% "
              f"of the device's busy time")
        for name in sorted(k for k in busy if key in k):
            print(f"    {count[name]} x {name[:110]}")
    # the prefill's norms in the order they ran: each layer's norm1 (bf16
    # x) and gated norm (f32 x), then final_norm (bf16 x); where the
    # profiler's list falls short of the wrapper's count, which is missing
    seen = ["norm1" if "rows<__nv_bfloat16" in n else "gated"
            for n in order if "rmsnorm_kernel" in n]
    path = ["norm1", "gated"] * cfg.n_layers + ["final_norm"]
    lacks = ""
    for i in range(len(path)):
        if seen == [k.replace("final_norm", "norm1")
                    for k in path[:i] + path[i + 1:]]:
            lacks = (f"; it lacks launch {i + 1}, {path[i]}"
                     + (f" of layer {i // 2}" if i < len(path) - 1 else ""))
            break
    print(f"[12] the profiler lists {len(seen)} of the prefill's "
          f"{len(path)} RMSNorm launches{lacks}")
    cache = grow_decode_cache(cfg, cache, SERVE_BATCH,
                              SERVE_PROMPT + PROFILE_DECODE_STEPS)
    tok = torch.argmax(logits[:, :V], -1)[:, None].to(torch.int32)

    def decode_steps():
        lg, c, t = logits, cache, tok
        for _ in range(PROFILE_DECODE_STEPS):
            lg, c = decode(params, t, c)
            t = torch.argmax(lg[:, :V], -1)[:, None].to(torch.int32)
        return t

    _, wall, busy, count, _ = device_activity(decode_steps)
    print_activity(f"{PROFILE_DECODE_STEPS} decode steps", wall, busy, count,
                   steps=PROFILE_DECODE_STEPS)

    # 13. energy: the card's watts, the LQCD calibration on the card, and
    # the LQCD and HPL workloads through cluster.run
    del cache, logits, params, batch
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    psi_e = eo_pack(psi, 0)

    def normal_op():
        schur_matvec_dagger(U_e, U_o, schur_matvec(U_e, U_o, psi_e, KAPPA),
                            KAPPA)

    a_big = randn(HPL_N, HPL_N)
    l21, u12, a22 = a_big[HPL_NB:, :HPL_NB], \
        a_big[:HPL_NB, 2 * HPL_NB:], a_big[HPL_NB:, 2 * HPL_NB:]
    table = {"idle": PM.H100_IDLE_W, "A^dagger A (HBM-bound)":
             PM.H100_MEM_BOUND_W, "step-0 GEMM (compute-bound)":
             PM.H100_COMPUTE_BOUND_W}
    loads = {"idle": None, "A^dagger A (HBM-bound)": normal_op,
             "step-0 GEMM (compute-bound)":
             lambda: G.dgemm_update_(a22, l21, u12)}
    op_flops = 2 * THERMAL_LATTICE.volume * dslash_flops_per_site()
    watts, rates = {}, {}
    for what, fn in loads.items():
        w, n, clock, rates[what] = read_watts(fn)
        watts[what] = w
        print(f"[13] {what}: {w:.2f} W mean of {n} samples, SM clock "
              f"{clock:.0f} MHz, {rates[what]:.1f} calls/s in the "
              f"{WATT_WINDOW_S:.0f} s window; {w / table[what]:.3f} x the "
              f"table's {table[what]:.2f} W ({PM.H100_MEASURED_ON})")
    w_idle, w_mem, w_gemm = watts.values()
    mem_rate = rates["A^dagger A (HBM-bound)"] * op_flops / 1e9
    check(w_idle < w_mem <= 1.05 * power_limit_w,
          f"idle {w_idle:.1f} W < HBM-bound {w_mem:.1f} W <= 1.05 x the "
          f"{power_limit_w} W limit")
    check(w_gemm <= 1.05 * power_limit_w,
          f"compute-bound {w_gemm:.1f} W <= 1.05 x the {power_limit_w} W "
          f"limit")
    del a_big, l21, u12, a22
    torch.cuda.empty_cache()

    K.reset_launches()
    reps = 5
    cal = measured_lqcd_calibration(THERMAL_LATTICE.shape, reps=reps,
                                    device="cuda")
    print(f"[13] measured_lqcd_calibration({THERMAL_LATTICE.shape}, "
          f"device='cuda'): {reps} A^dagger A in {cal.wall_s * 1e3:.3f} ms, "
          f"{cal.gflops:.1f} GFLOP/s, {cal.eff_bw_gbs:.1f} GB/s, busy "
          f"{cal.busy_w:.2f} W (the table's), {cal.gflops_per_w:.4f} "
          f"GFLOP/s/W; with the HBM-bound watts read above "
          f"{cal.gflops / w_mem:.4f} GFLOP/s/W; launches {dict(K.LAUNCHES)}."
          f"  The watts window's A^dagger A loop ran at {mem_rate:.1f} "
          f"GFLOP/s, {mem_rate / w_mem:.4f} GFLOP/s/W")
    check(K.LAUNCHES["dslash_eo_split"] == K.LAUNCHES["dslash_eo_fused"]
          == 4 * (reps + 1) and K.LAUNCHES["dslash_split"] == 0,
          "the calibration launched 4 fused EO hops per A^dagger A, "
          "warm-up included")
    check(cal.source == "measured" and cal.gflops > 0
          and abs(cal.energy_j - cal.busy_w * cal.wall_s)
          <= 1e-9 * cal.energy_j, "calibration joules = busy W x wall")

    # nvidia-smi samples every 100 ms and the window needs ten samples:
    # HPL at n = 32768 takes ~0.8 s since its panel became a kernel
    hpl_cfg = HPLConfig(n=3 * HPL_N // 2, block=HPL_NB)
    steps = hpl_cfg.n // hpl_cfg.block
    for mod in (K, G):
        mod.reset_launches()
    t0 = time.perf_counter()
    with PowerSamples() as run_w:
        res = run([LQCDSolveWorkload(lattice=THERMAL_LATTICE,
                                     calibration=cal),
                   HPLWorkload(cfg=hpl_cfg)])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    e_launches = {**K.LAUNCHES, **G.LAUNCHES}
    lq, hpl = res.results
    it, outer = lq.details["iters"], lq.details["outer_iters"]
    n_gemm = (steps - 1) + (steps - 2 if hpl_cfg.lookahead else 0)
    want = {"dslash_eo_split": 4 * it + 4 * outer + 2, "dslash_split": 1,
            "dslash_eo_fused": 4 * it + 4 * outer,
            "dgemm": n_gemm, "dgemm_128x128": n_gemm, "dgemm_64x128": 0}
    for r in res.results:
        t_end = float(r.power_trace.t[-1])
        integral = r.power_trace.energy_j(t0=t_end - r.wall_s, t1=t_end)
        print(f"[13] {r.kind} at {r.details['op_f_mhz']:.0f} MHz "
              f"(its placement's point): {r.perf_gflops:.2f} GFLOP/s over "
              f"{r.wall_s:.6f} s, {r.energy_j:.4f} J, "
              f"{r.gflops_per_w:.4f} GFLOP/s/W; the trace's integral over "
              f"that window {integral:.4f} J")
        check(abs(r.energy_j - integral) <= 1e-9 * integral,
              f"{r.kind} joules = its trace's integral over its window")
    print(f"[13] the LQCD solve: {it} inner normal ops + {outer} outer, "
          f"rel. residual {lq.details['rel_residual']:.3e}, converged "
          f"{lq.details['converged']}; HPL scaled residual "
          f"{hpl.details['residual']:.4e}, passed {hpl.details['passed']}, "
          f"energy plan {float(hpl.power_trace.aux['freq_scale'][-1]):.3f} "
          f"x clock at {float(hpl.power_trace.components['chip'][-1]):.2f} "
          f"W; launches {e_launches} (want {want}); run() took {wall:.2f} s")
    print(f"[13] nvidia-smi over run(): {run_w.mean_w:.2f} W mean of "
          f"{len(run_w.watts)} samples (max {max(run_w.watts):.2f} W); HPL's "
          f"{hpl.perf_gflops:.2f} GFLOP/s at that draw is "
          f"{hpl.perf_gflops / run_w.mean_w:.4f} GFLOP/s/W (the plan's "
          f"watts give {hpl.gflops_per_w:.4f})")
    check(lq.details["converged"] and lq.details["rel_residual"] <= 1e-6,
          "the workload's solve converged")
    check(hpl.details["passed"], "the workload's HPL passed")
    check(e_launches == want, f"launch counts on the energy path {want}")
    l3 = res.efficiency(3)
    print(f"[13] the merged L-CSC trace ({res.schedule.topology.n_nodes} "
          f"nodes, modelled): makespan {res.makespan:.1f} s, L3 "
          f"{l3.mflops_per_w:.1f} MFLOPS/W at {l3.avg_power_w:.0f} W; "
          f"phase 13 took {time.perf_counter() - t13:.1f} s")

    # 14. the T-sharded path: several shards on the one card
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    card = f"{kind}, {power_limit_w:.2f} W"
    sharded = {"dslash_eo_split": {}}

    def hop_ms(fn):
        # 20 calls: a sharded hop over 4 shards is 24 launches, and with
        # 50 calls queued the card's launch queue (~1000 deep) blocked
        # the host before the sleep ended, in every retry
        return timed_ms(fn, reps=20, warmup=3)

    # 14a. the sharded EO hop against the one-device hop, bit for bit
    one_ms = hop_ms(lambda: K.dslash_eo_split(*eo_args))
    for n in (2, 4):
        mesh = lattice_mesh(lat[3], n)
        ops = ShardedWilsonEO(U_e, U_o, KAPPA, mesh)
        check(ops.backend == "kernel" and mesh.n == n
              and len(mesh.distinct_devices) == 1,
              f"{n} shards on the one card, on the kernel path")
        for src_parity in (0, 1):
            p = eo_pack(psi, src_parity)
            U_out, U_src = (U_o, U_e) if src_parity == 0 else (U_e, U_o)
            want = dslash_half(U_out, U_src, p, src_parity)
            K.reset_launches()
            got = ops.dslash_half(p, src_parity)
            n_launch = K.LAUNCHES["dslash_eo_split"]
            torch.cuda.synchronize()
            diff = float((got - want).abs().max())
            print(f"[14a] sharded EO hop at {lat} over {n} shards "
                  f"(T_local {lat[3] // n}, padded to {lat[3] // n + 2}), "
                  f"src parity {src_parity}: max|diff| vs the one-device "
                  f"B1 {diff:.1e}, {n_launch} B1 launches ({card})")
            check(torch.equal(got, want), "the sharded EO hop equals the "
                  "one-device hop bit for bit")
            check(n_launch == n, f"one B1 launch per shard ({n})")
        blocks = ops._split(eo_pack(psi, 0))
        ms = hop_ms(lambda: ops._hop(blocks, 0))
        sharded["dslash_eo_split"][f"{lat[3]}/{n}"] = ms
        print(f"[14a] sharded EO hop at {lat} over {n} shards: {ms * 1e3:.1f}"
              f" us device time per hop on per-shard blocks (halos, pads, "
              f"{n} B1 launches, crops), one-device B1 {one_ms * 1e3:.1f} us"
              f": {ms / one_ms:.3f} x ({card})")
    # B1 on one padded block (shard 0 of 4) against its plain version
    U_pad = ops._gauge
    idx = torch.tensor([lat[3] - 1, *range(ops.t_local + 1)], device=dev)
    pad_args = (to_split(U_pad[1][0]), to_split(U_pad[0][0]),
                to_split(eo_pack(psi, 0).index_select(3, idx).contiguous()),
                1)
    got = K.dslash_eo_split(*pad_args)
    want = dslash_eo_split_ref(*pad_args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    print(f"[14a] B1 on one padded block {tuple(pad_args[2].shape[:4])} vs "
          f"plain: max|err| {float((got - want).abs().max()):.3e} "
          f"(rtol=atol={TOL})")

    # 14b. the sharded full hop, compressed and not, against the one-device
    want = dslash(U, psi)
    for n in (2, 4):
        mesh = lattice_mesh(lat[3], n)
        K.reset_launches()
        c = dslash_sharded(U, psi, mesh, compress=True)
        u = dslash_sharded(U, psi, mesh, compress=False)
        n_launch = K.LAUNCHES["dslash_split"]
        torch.cuda.synchronize()
        print(f"[14b] dslash_sharded at {lat} over {n} shards: compressed vs "
              f"full halos max|diff| {float((c - u).abs().max()):.1e}, vs the "
              f"one-device B2 {float((c - want).abs().max()):.1e}; "
              f"{n_launch} B2 launches ({card})")
        check(torch.equal(c, u) and torch.equal(c, want),
              "the sharded full hop equals the one-device hop bit for bit, "
              "with and without compressed halos")
        check(n_launch == 2 * n, "one B2 launch per shard and call")
    del c, u, want

    # 14c. the sharded solve at full size beside the one-device solve
    def solve_pair(U_, b_, n):
        out = []
        for mesh in (None, lattice_mesh(U_.shape[4], n)):
            torch.cuda.synchronize()
            K.reset_launches()
            t0 = time.perf_counter()
            res = solve_dirac(U_, b_, KAPPA, EO_MIXED_SOLVER, mesh=mesh)
            torch.cuda.synchronize()
            out.append((res, time.perf_counter() - t0, dict(K.LAUNCHES)))
        (one, w1, l1), (sh, w2, l2) = out
        shape = tuple(U_.shape[1:5])
        dx = float((sh.x - one.x).abs().max() / one.x.abs().max())
        for what, res, wall, lc, k in (("one device", one, w1, l1, 1),
                                       (f"{n} shards", sh, w2, l2, n)):
            print(f"[14c] EO_MIXED at {shape}, {what}: {res.iters} inner + "
                  f"{res.outer_iters} outer, true rel. residual "
                  f"{res.rel_residual:.3e}, {wall * 1e3:.1f} ms wall; "
                  f"launches {lc} ({card})")
            check(res.converged and res.rel_residual <= 1e-6,
                  f"the {what} solve at {shape} converged to <= 1e-6")
            check(lc["dslash_eo_split"] == k * (4 * res.iters
                                                + 4 * res.outer_iters + 2)
                  and lc["dslash_split"] == k,
                  f"B1 launched per hop and shard in the {what} solve")
        print(f"[14c] {shape}: max|x_sharded - x_one| / max|x_one| {dx:.2e}")
        check(abs(sh.iters - one.iters) <= 2
              and abs(sh.outer_iters - one.outer_iters) <= 1,
              "sharded and one-device iterations within 2 (outer 1)")
        check(dx <= 1e-3, "sharded and one-device solutions within 1e-3")
        return sh, w1, w2, l2

    U_c, b_c = random_field_and_source(COLD_LATTICE.shape, SEED, dev)
    cold, w_one, w_sh, cold_l = solve_pair(U_c, b_c, 4)
    solve_pair(U, rhs[0], 2)
    # where the sharded solve's time goes: one more under torch.profiler
    for mesh in (None, lattice_mesh(64, 4)):
        _, wall, busy, count, _ = device_activity(
            lambda: solve_dirac(U_c, b_c, KAPPA, EO_MIXED_SOLVER, mesh=mesh))
        total, n_act = sum(busy.values()), sum(count.values())
        b1 = [sum(v for k, v in d.items() if "dslash_eo_kernel" in k)
              for d in (busy, count)]
        print(f"[14c] profiled EO_MIXED at {COLD_LATTICE.shape}, "
              f"{'one device' if mesh is None else '4 shards'}: "
              f"{wall * 1e3:.1f} ms wall, device busy {total * 1e3:.1f} ms "
              f"({100 * total / wall:.1f}%, idle {100 - 100 * total / wall:.1f}"
              f"%) in {n_act} device activities; B1 {b1[0] * 1e3:.1f} ms in "
              f"{b1[1]} launches ({card}); the largest others:")
        for name in sorted(busy, key=busy.get, reverse=True)[:4]:
            if "dslash_eo_kernel" not in name:
                print(f"    {busy[name] * 1e3:.3f} ms in {count[name]} x "
                      f"{name[:90]}")
    sharded["solve"] = {"lattice": list(COLD_LATTICE.shape), "shards": 4,
                        "ms_one_device": w_one * 1e3, "ms_sharded": w_sh * 1e3,
                        "iters": cold.iters, "outer_iters": cold.outer_iters,
                        "launches": cold_l}
    # the hops at 32^3 x 64 whose times follow, checked on the inputs the
    # timings reuse: the sharded EO hop over 4 shards (T_local 16, padded
    # to 18) equal to the one-device B1 bit for bit; B1 on shard 0's
    # padded block, the one-device B1 and the one-device B2 (the solve's
    # true residual) against their plain versions
    U_ce, U_co = pack_gauge(U_c)
    ops = ShardedWilsonEO(U_ce, U_co, KAPPA, lattice_mesh(64, 4))
    for src_parity in (0, 1):
        p = eo_pack(b_c, src_parity)
        U_out, U_src = (U_co, U_ce) if src_parity == 0 else (U_ce, U_co)
        want = dslash_half(U_out, U_src, p, src_parity)
        K.reset_launches()
        got = ops.dslash_half(p, src_parity)
        n_launch = K.LAUNCHES["dslash_eo_split"]
        torch.cuda.synchronize()
        print(f"[14c] sharded EO hop at {COLD_LATTICE.shape} over 4 shards "
              f"(T_local {ops.t_local}, padded to {ops.t_local + 2}), src "
              f"parity {src_parity}: max|diff| vs the one-device B1 "
              f"{float((got - want).abs().max()):.1e}, {n_launch} B1 "
              f"launches ({card})")
        check(torch.equal(got, want), "the sharded EO hop at 32^3 x 64 "
              "equals the one-device hop bit for bit")
        check(n_launch == 4, "one B1 launch per shard (4)")
    del p, got, want
    idx = torch.tensor([63, *range(ops.t_local + 1)], device=dev)
    cold_pad = (to_split(ops._gauge[1][0]), to_split(ops._gauge[0][0]),
                to_split(eo_pack(b_c, 0).index_select(3, idx).contiguous()),
                1)
    cold_args = (to_split(U_co), to_split(U_ce),
                 to_split(eo_pack(b_c, 0)), 0)
    full_args = (to_split(U_c), to_split(b_c))
    for what, fn, ref_fn, args, psi_s in (
            ("B1 on shard 0's padded block", K.dslash_eo_split,
             dslash_eo_split_ref, cold_pad, cold_pad[2]),
            ("one-device B1", K.dslash_eo_split, dslash_eo_split_ref,
             cold_args, cold_args[2]),
            ("one-device B2", K.dslash_split, dslash_split_ref, full_args,
             full_args[1])):
        got, want = fn(*args), ref_fn(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
        print(f"[14c] {what} {tuple(psi_s.shape[:4])} vs plain: max|err| "
              f"{err:.3e} (rtol=atol={TOL}) ({card})")
        del got, want
    del cold_pad, full_args, psi_s
    torch.cuda.empty_cache()
    # the hop's device time at 32^3 x 64, one device and over 4 shards
    one_cold = hop_ms(lambda: K.dslash_eo_split(*cold_args))
    b_ms, b_by = bound([cold_args[0], cold_args[1], cold_args[2],
                        cold_args[2]], cold_args[2].shape[:4].numel(),
                       dslash_flops_per_site())
    blocks = ops._split(eo_pack(b_c, 0))
    ms = hop_ms(lambda: ops._hop(blocks, 0))
    sharded["dslash_eo_split"]["64/4"] = ms
    print(f"[14c] EO hop at {COLD_LATTICE.shape}: one-device B1 "
          f"{one_cold * 1e3:.1f} us ({100 * b_ms / one_cold:.1f}% of the "
          f"{b_ms * 1e3:.1f} us {b_by} bound); over 4 shards "
          f"{ms * 1e3:.1f} us ({ms / one_cold:.3f} x; {100 * b_ms / ms:.1f}% "
          f"of the bound) ({card})")
    sharded["dslash_eo_split"]["64/1"] = one_cold
    del ops, blocks, U_c, b_c, U_ce, U_co, cold_args, cold
    torch.cuda.empty_cache()

    # 14d. the calibration over 4 shards on the one card
    cal_one = measured_lqcd_calibration(THERMAL_LATTICE.shape, reps=reps)
    K.reset_launches()
    cal_sh = measured_lqcd_calibration(THERMAL_LATTICE.shape, reps=reps,
                                       mesh=lattice_mesh(8, 4))
    print(f"[14d] measured_lqcd_calibration({THERMAL_LATTICE.shape}): "
          f"one device {cal_one.gflops:.1f} GFLOP/s, 4 shards "
          f"{cal_sh.gflops:.1f} GFLOP/s, ratio "
          f"{cal_sh.gflops / cal_one.gflops:.3f} (the cost of 4 shards on "
          f"one card: pad rows, halo copies, 4 x the launches; not a "
          f"multi-GPU loss); n_devices {cal_sh.n_devices}; launches "
          f"{dict(K.LAUNCHES)} ({card})")
    check(cal_sh.n_devices == 1, "4 shards on one card bill one device")
    check(K.LAUNCHES["dslash_eo_split"] == 4 * 4 * (reps + 1),
          "the sharded calibration launched 4 B1 per hop")

    # 14e. a sharded solve on the CPU (plain) against the card (B1)
    small = (8, 8, 8, 16)
    U_s8, b_s8 = gauge(small, "cpu"), spinor(small, "cpu")
    r_cpu = solve_dirac(U_s8, b_s8, KAPPA, EO_MIXED_SOLVER,
                        mesh=lattice_mesh(16, 4, devices=("cpu",)))
    K.reset_launches()
    r_gpu = solve_dirac(U_s8.to(dev), b_s8.to(dev), KAPPA, EO_MIXED_SOLVER,
                        mesh=lattice_mesh(16, 4))
    x_gpu = r_gpu.x.cpu()
    ok = torch.allclose(x_gpu, r_cpu.x, rtol=1e-3, atol=1e-4)
    print(f"[14e] {small} over 4 shards, CPU plain vs card B1: iters "
          f"{r_cpu.iters}+{r_cpu.outer_iters} vs {r_gpu.iters}+"
          f"{r_gpu.outer_iters}, max|dx| "
          f"{float((x_gpu - r_cpu.x).abs().max()):.2e}; card launches "
          f"{dict(K.LAUNCHES)}")
    check(r_cpu.converged and r_gpu.converged, "both sharded solves converged")
    check(abs(r_cpu.iters - r_gpu.iters) <= 2 and ok,
          "the sharded solve on the card agrees with the CPU's")
    for rec in records:
        if rec["name"] in ("dslash_eo_split", "dslash_split"):
            rec["sharded"] = {"launches_32x32x32x64_4_shards":
                              cold_l[rec["name"]]}
            if rec["name"] == "dslash_eo_split":
                rec["sharded"]["hop_ms_by_T_and_shards"] = \
                    sharded["dslash_eo_split"]
                rec["sharded"]["solve"] = sharded["solve"]
    print(f"[14] phase 14 took {time.perf_counter() - t14:.1f} s ({card})")


    # 15. the autotuner on the card, and the GEMM's two tiles
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    set_default_cache(TuneCache())     # in memory, empty
    # 15a. the 64 x 128 tile against the 128 x 128 tile, bit for bit, and
    # against the plain version
    tile_err = 0.0
    for m, n, k in GEMM_SWEEP + [GEMM_RAGGED, SMALL_GEMM]:
        for dtype in (torch.float32, torch.bfloat16):
            x, y, c = randn(m, k, dtype=dtype), randn(k, n, dtype=dtype), \
                randn(m, n, dtype=dtype)
            p128, p64 = G.dgemm(x, y), G.dgemm(x, y, bm=64)
            c128, c64 = c.clone(), c.clone()
            G.dgemm_update_(c128, x, y)
            G.dgemm_update_(c64, x, y, bm=64)
            want, want_c = dgemm_ref(x, y), dgemm_update_ref_(c.clone(), x, y)
            torch.cuda.synchronize()
            check(torch.equal(p64, p128) and torch.equal(c64, c128),
                  f"B3's tiles agree bit for bit at {(m, n, k)}, {dtype}")
            torch.testing.assert_close(p64, want, **gemm_tol[dtype])
            torch.testing.assert_close(c64, want_c, **gemm_tol[dtype])
            if dtype == torch.float32:
                tile_err = max(tile_err, float((p64 - want).abs().max()),
                               float((c64 - want_c).abs().max()))
    a = randn(1024, 1024)
    t128, t64 = a.clone(), a.clone()
    for t, bm in ((t128, 128), (t64, 64)):
        G.dgemm_update_(t[131:, 131:], t[131:, 3:131], t[3:131, 131:], bm=bm)
        G.dgemm(t[5:75, 3:22], t[103:122, 1:39], bm=bm)
    torch.cuda.synchronize()
    check(torch.equal(t64, t128), "B3's tiles agree on unaligned views")

    def rest_views(t):
        """Step 0's larger update (the rest, after the next panel)."""
        return (t[HPL_NB:, 2 * HPL_NB:], t[HPL_NB:, :HPL_NB],
                t[:HPL_NB, 2 * HPL_NB:])

    a_big = randn(HPL_N, HPL_N)
    t64, want = a_big.clone(), a_big.clone()
    G.dgemm_update_(*rest_views(a_big))
    G.dgemm_update_(*rest_views(t64), bm=64)
    dgemm_update_ref_(*rest_views(want))
    torch.cuda.synchronize()
    check(torch.equal(t64, a_big), "B3's tiles agree bit for bit at step "
          "0's update, n = 32768")
    torch.testing.assert_close(t64, want, **gemm_tol[torch.float32])
    step0_err = float((t64 - want).abs().max())
    tile_err = max(tile_err, step0_err)
    del t64, want, a, t128
    torch.cuda.empty_cache()
    print(f"[15] B3's 64 x 128 tile equals the 128 x 128 tile bit for bit "
          f"({GEMM_SWEEP}, ragged {GEMM_RAGGED}, {SMALL_GEMM}, f32 and bf16, "
          f"product and update; unaligned views; step 0's update at "
          f"n={HPL_N}); max|err| vs plain in f32 {tile_err:.3e} (step 0: "
          f"{step0_err:.3e})")

    # 15b. each tile's time, in turns, at step 0's update and at a small
    # product, beside each shape's bound
    a22, l21, u12 = rest_views(a_big)
    xs, ys = randn(SMALL_GEMM[0], SMALL_GEMM[2]), \
        randn(SMALL_GEMM[2], SMALL_GEMM[1])
    out_s = torch.empty(SMALL_GEMM[:2], device=dev)
    shapes = {
        "step-0 update": (lambda bm: G.dgemm_update_(a22, l21, u12, bm=bm),
                          10, 2, [l21, u12, a22, a22],
                          2 * a22.shape[0] * a22.shape[1] * HPL_NB),
        "small product": (lambda bm: G.dgemm(xs, ys, bm=bm), 200, 20,
                          [xs, ys, out_s], 2 * math.prod(SMALL_GEMM))}
    tile_ms = {}
    for what, (fn, reps, warm, in_out, flops) in shapes.items():
        reads = {128: [], 64: []}
        for bm in (128, 64, 64, 128):
            reads[bm].append(timed_ms(lambda: fn(bm), reps=reps,
                                      warmup=warm))
        b_ms, b_by = bound(in_out, flops, 1)
        for bm, r in reads.items():
            ms = sum(r) / len(r)
            tile_ms[what, bm] = ms
            print(f"[15] {bm} x 128 tile, {what}: {ms:.4f} ms (readings "
                  f"{r[0]:.4f}, {r[1]:.4f}), {flops / ms / 1e9:.2f} "
                  f"TFLOP/s, {100 * b_ms / ms:.1f}% of the {b_ms:.4f} ms "
                  f"{b_by} bound ({card})")
    # the plain version's and the library's times for the small product
    # (TF32 off, as set in [1])
    small_plain_ms = timed_ms(lambda: dgemm_ref(xs, ys), reps=200,
                              warmup=20, host_paced_ok=True)
    small_lib_ms = timed_ms(lambda: torch.matmul(xs, ys), reps=200,
                            warmup=20)
    print(f"[15] small product {SMALL_GEMM[0]} x {SMALL_GEMM[2]} @ "
          f"{SMALL_GEMM[2]} x {SMALL_GEMM[1]} f32 (TF32 off): plain "
          f"{small_plain_ms:.4f} ms, torch.matmul {small_lib_ms:.4f} ms "
          f"({card})")
    del a22, l21, u12, a_big, out_s
    torch.cuda.empty_cache()

    # 15c. the autotuner's path on the card, its launches counted
    torch.cuda.synchronize()
    K.reset_launches()
    G.reset_launches()
    picks = {}
    for shape in ((HPL_N - HPL_NB, HPL_NB, HPL_N - 2 * HPL_NB),
                  (SMALL_GEMM[0], SMALL_GEMM[2], SMALL_GEMM[1])):
        for how in ("analytic", "measured"):
            res = tune_dgemm_tiles(*shape, measured=how == "measured")
            picks[shape, how] = res.best.point["bm"]
            cands = ", ".join(f"bm {c.point['bm']}: {c.perf_gflops:.1f} "
                              f"GFLOP/s at {c.power_w:.1f} W"
                              for c in res.trace)
            print(f"[15] {how} dgemm pick at (m, k, n) = {shape}: "
                  f"{res.best.point} ({cands}) ({card})")
    got = GO.dgemm(xs, ys, tuned=True)
    # the measured HPL blocking search, twice, to show how far its pick
    # holds from one search to the next
    hpl_searches = []
    for _ in range(HPL_TUNE_SEARCHES):
        hpl_model = MeasuredHPLModel(HPL_TUNE_N)
        hpl_res = grid_search(hpl_blocking_space(HPL_TUNE_N), hpl_model,
                              max_perf_loss=EFFICIENCY_PERF_LOSS)
        hpl_searches.append((hpl_model, hpl_res))
    analytic_hpl = tune_hpl_blocking(HPL_TUNE_N)
    tuned_big = HPLConfig(n=HPL_N).tuned()
    torch.cuda.synchronize()
    tune_launches = {**K.LAUNCHES, **G.LAUNCHES}
    torch.testing.assert_close(got, dgemm_ref(xs, ys),
                               **gemm_tol[torch.float32])
    for i, (hpl_model, hpl_res) in enumerate(hpl_searches):
        by_point = {}
        for point, r in hpl_model.runs:
            by_point.setdefault((point["block"], point["lookahead"]),
                                []).append(r)
        for (block, la), rs in by_point.items():
            print(f"[15] search {i}: linpack_run(n={HPL_TUNE_N}, "
                  f"block={block}, lookahead={la}): walls "
                  + ", ".join(f"{r.wall_s:.4f}" for r in rs) + " s, best "
                  f"{max(r.gflops for r in rs):.1f} GFLOP/s, scaled "
                  f"residuals " + ", ".join(f"{r.residual:.4e}" for r in rs)
                  + f", passed {all(r.passed for r in rs)} ({card})")
        print(f"[15] HPL blocking at n={HPL_TUNE_N}, search {i}: measured "
              f"pick {hpl_res.best.point} ({hpl_res.best.perf_gflops:.1f} "
              f"GFLOP/s, {hpl_res.best.mflops_per_w:.1f} MFLOPS/W by the "
              f"node model, {hpl_res.evaluations} points, "
              f"{len(hpl_model.runs)} runs) ({card})")
        check(all(r.passed for _, r in hpl_model.runs)
              and len(hpl_model.runs)
              == hpl_res.evaluations * hpl_model.reps,
              "every HPL run of the blocking search passed")
    print(f"[15] HPL blocking at n={HPL_TUNE_N}: measured picks "
          f"{[res.best.point for _, res in hpl_searches]}, analytic pick "
          f"{analytic_hpl.best.point}; HPLConfig(n={HPL_N}).tuned() gives "
          f"block {tuned_big.block}, lookahead {tuned_big.lookahead} (not "
          f"run); launches on the autotuner's path {tune_launches} ({card})")
    check(analytic_hpl.best.point == {"block": HPL_TUNE_N // 4,
                                      "lookahead": 1}
          and (tuned_big.block, tuned_big.lookahead) == (HPL_N // 4, 1),
          "the analytic HPL blocking picks n / 4")
    check(picks[(SMALL_GEMM[0], SMALL_GEMM[2], SMALL_GEMM[1]), "analytic"]
          == 64 and picks[(HPL_N - HPL_NB, HPL_NB, HPL_N - 2 * HPL_NB),
                          "analytic"] == 128,
          "the analytic dgemm picks: 64 rows small, 128 at step 0")
    check(tune_launches["dgemm_64x128"] > 0
          and tune_launches["dgemm_128x128"] > 0,
          "both B3 tiles launched on the autotuner's path")
    check(tune_launches["dgemm"] == tune_launches["dgemm_64x128"]
          + tune_launches["dgemm_128x128"], "B3's launches by tile add up")
    gemm_rec = next(r for r in records if r["name"] == "dgemm")
    records.append({
        "name": "dgemm_64x128", "route": "cuda", "source": GEMM_SOURCE,
        "replaces": GEMM_REPLACES,
        "launches": tune_launches["dgemm_64x128"],
        "max_abs_err": tile_err, "ms": tile_ms["step-0 update", 64],
        "plain_ms": gemm_rec["plain_ms"], "bound_ms": gemm_rec["bound_ms"],
        "bound_by": gemm_rec["bound_by"],
        "library_ms": gemm_rec["library_ms"],
        "small_product_ms": tile_ms["small product", 64],
        "small_product_ms_128x128": tile_ms["small product", 128],
        "small_product_plain_ms": small_plain_ms,
        "small_product_library_ms": small_lib_ms,
        "step0_ms_128x128_in_turns": tile_ms["step-0 update", 128]})
    set_default_cache(None)
    print(f"[15] phase 15 took {time.perf_counter() - t15:.1f} s ({card})")

    # 16. the online simulator and trace replay, executed on the card
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    sim_hpl = HPLConfig(n=SIM_HPL_N, block=SIM_HPL_NB)

    def sim_arrivals():
        lq = dict(lattice=SMOKE_LATTICE, calibration=cal)
        return [(0.0, HPLWorkload(cfg=sim_hpl)),
                (60.0, LQCDSolveWorkload(**lq)),
                (120.0, LQCDSolveWorkload(name="lqcd2", seed=1, **lq)),
                (300.0, HPLWorkload(name="hpl2", cfg=sim_hpl)),
                (900.0, LQCDSolveWorkload(name="lqcd3", seed=2, **lq))]

    sim_kw = dict(topology=ClusterTopology(n_nodes=2), dt_s=30.0,
                  failure_model=WeibullFailureModel(
                      mtbf_s=SIM_MTBF_S, shape=1.0, repair_s=SIM_REPAIR_S),
                  seed=SIM_SEED, checkpoint=CheckpointPolicy())
    plain_sim = simulate(sim_arrivals(), **sim_kw)
    for mod in (K, G, RK, SK, PK):
        mod.reset_launches()
    t0 = time.perf_counter()
    ex_sim = simulate(sim_arrivals(), execute=True, **sim_kw)
    torch.cuda.synchronize()
    sim_wall = time.perf_counter() - t0
    sim_launches = {**K.LAUNCHES, **G.LAUNCHES, **RK.LAUNCHES,
                    **SK.LAUNCHES, **PK.LAUNCHES}

    def sim_view(r):
        tr = r.trace
        return ([(p.job.name, p.start, p.end, tuple(p.chips), p.op)
                 for p in r.schedule.placements],
                [(q.uid, q.start_s, q.end_s, q.requeues, q.state,
                  q.completed_fraction, q.checkpoints) for q in r.records],
                r.outages, dataclasses.asdict(r.stats), tr.meta,
                [tr.t, tr.flops_rate] + [tr.components[k]
                                         for k in sorted(tr.components)]
                + [tr.aux[k] for k in sorted(tr.aux)],
                sorted(tr.components), sorted(tr.aux))

    a, b = sim_view(ex_sim), sim_view(plain_sim)
    same = a[:5] == b[:5] and a[6:] == b[6:] and len(a[5]) == len(b[5]) \
        and all(np.array_equal(x, y) for x, y in zip(a[5], b[5]))
    st = ex_sim.stats
    placed = [(q.job.name, round(q.start, 1), round(q.end, 1), len(q.chips))
              for q in ex_sim.schedule.placements]
    print(f"[16a] simulate(execute=True) on {len(ex_sim.records)} arrivals "
          f"({SIM_HPL_N}-HPL x2, {SMOKE_LATTICE.shape} LQCD x3) over 2 "
          f"nodes: {st.node_failures} node failures, {st.requeues} "
          f"requeues, {st.checkpoints} checkpoints, makespan "
          f"{st.makespan_s:.1f} s (modelled); outages {ex_sim.outages}; "
          f"placements {placed}; "
          f"equal to execute=False bit for bit: {same}; the executions "
          f"took {sim_wall:.2f} s ({card})")
    check(same, "the executed simulator's placements, records, outages, "
                "stats and trace equal execute=False's bit for bit")
    check(st.requeues >= 1 and st.checkpoints >= 1,
          f"seed {SIM_SEED} kills and requeues a job, and a checkpoint "
          f"is written")
    done = [q.uid for q in ex_sim.records if q.state == "completed"]
    check(sorted(ex_sim.results) == done == list(range(5)),
          "every arrival completed and carries its WorkloadResult")
    steps16 = SIM_HPL_N // SIM_HPL_NB
    want16 = dict.fromkeys(sim_launches, 0)
    for uid in done:
        r = ex_sim.results[uid]
        print(f"[16a] uid {uid} {r.name} at {r.details['op_f_mhz']:.0f} "
              f"MHz: {r.perf_gflops:.2f} GFLOP/s over {r.wall_s:.6f} s, "
              f"{r.energy_j:.4f} J; "
              + (f"residual {r.details['residual']:.4e}, passed "
                 f"{r.details['passed']}" if r.kind == "hpl" else
                 f"{r.details['iters']} + {r.details['outer_iters']} "
                 f"normal ops, rel. residual "
                 f"{r.details['rel_residual']:.3e}"))
        if r.kind == "hpl":
            check(r.details["passed"], f"uid {uid}: HPL's residual passes")
            n_gemm = (steps16 - 1) + (steps16 - 2)
            want16["dgemm"] += n_gemm
            want16["dgemm_128x128"] += n_gemm
            want16["panel_lu"] += steps16
            want16["laswp"] += steps16
        else:
            check(r.details["converged"]
                  and r.details["rel_residual"] <= 1e-6,
                  f"uid {uid}: the LQCD solve converges")
            hops = 4 * r.details["iters"] + 4 * r.details["outer_iters"]
            want16["dslash_eo_split"] += hops + 2
            want16["dslash_eo_fused"] += hops
            want16["dslash_split"] += 1
    print(f"[16a] launches {sim_launches} (want {want16})")
    check(sim_launches == want16, "B1-B3 and the panel kernels launched "
                                  "as the executed workloads' steps and "
                                  "iterations imply")

    # 16b. trace replay with executed tokens, mamba2-370m at full width
    cost = ServeCostModel(ARCH, max_batch=REPLAY_BATCH,
                          prompt_len=max(REPLAY_PROMPTS),
                          gen=max(REPLAY_GENS), smoke=False)
    plan16, _, _ = cost.plan()
    t_pre16, _ = cost.prefill_cost(max(REPLAY_PROMPTS), REPLAY_BATCH)
    rate = 4.0 * REPLAY_BATCH / (t_pre16 + max(REPLAY_GENS)
                                 * plan16.step_time_s)
    requests = poisson_trace(REPLAY_N, rate, prompt_lens=REPLAY_PROMPTS,
                             gen_lens=REPLAY_GENS, seed=REPLAY_SEED)
    bare = ContinuousBatchingEngine(cost).replay(requests)
    runtime = ExecutedGroupRuntime(ARCH, smoke=False, seed=REPLAY_SEED,
                                   device="cuda")
    for mod in (K, G, RK, SK, PK):
        mod.reset_launches()
    t0 = time.perf_counter()
    res16 = ContinuousBatchingEngine(cost, runtime=runtime).replay(requests)
    torch.cuda.synchronize()
    replay_wall = time.perf_counter() - t0
    replay_launches = {**K.LAUNCHES, **G.LAUNCHES, **RK.LAUNCHES,
                       **SK.LAUNCHES, **PK.LAUNCHES}
    tr_a, tr_b = res16.trace, bare.trace
    same = (dataclasses.asdict(res16.stats) == dataclasses.asdict(bare.stats)
            and np.array_equal(tr_a.t, tr_b.t)
            and np.array_equal(tr_a.flops_rate, tr_b.flops_rate)
            and sorted(tr_a.components) == sorted(tr_b.components)
            and all(np.array_equal(tr_a.components[k], tr_b.components[k])
                    for k in tr_b.components)
            and sorted(tr_a.aux) == sorted(tr_b.aux)
            and all(np.array_equal(tr_a.aux[k], tr_b.aux[k])
                    for k in tr_b.aux)
            and [(q.admit_s, q.first_token_s, q.done_s)
                 for q in res16.records]
            == [(q.admit_s, q.first_token_s, q.done_s)
                for q in bare.records])
    print(f"[16b] replayed {REPLAY_N} requests (prompts "
          f"{requests.prompt_len.tolist()}, generation "
          f"{requests.gen_len.tolist()}) through {len(runtime.groups)} "
          f"groups of {cfg.name} at full width in {replay_wall:.2f} s on "
          f"the card; the engine's report: {res16.stats.summary()} "
          f"(modelled, {cost.chip.name}); stats and trace equal the "
          f"replay without the runtime bit for bit: {same}")
    check(same, "the runtime only attaches tokens: stats, records' times "
                "and trace equal the bare replay's")
    for q in res16.records:
        check(q.tokens is not None and q.tokens.shape == (q.gen_len,)
              and bool(np.all((q.tokens >= 0) & (q.tokens < V))),
              f"request {q.idx} carries {q.gen_len} tokens in [0, {V})")
    want_b = dict.fromkeys(replay_launches, 0)
    for s16, n16, g16, pre_s, dec_s in runtime.groups:
        want_b["rmsnorm"] += (2 * L + 1) * (1 + g16)
        want_b["ssd_chunk"] += L * -(-s16 // sc.chunk_size)
        print(f"[16b] group of {n16} x {s16} prompt tokens, {g16} steps: "
              f"prefill {pre_s * 1e3:.2f} ms measured against "
              f"{cost.prefill_cost(s16, n16)[0] * 1e3:.4f} ms analytic; "
              f"decode {dec_s / g16 * 1e3:.2f} ms per step measured "
              f"against {plan16.step_time_s * 1e3:.4f} ms analytic "
              f"(freq {plan16.freq_scale:.3f}, {plan16.power_w:.1f} W "
              f"modelled) ({card})")
    print(f"[16b] launches {replay_launches} (want {want_b}); sample "
          f"{res16.records[0].tokens[:16].tolist()}")
    check(replay_launches == want_b, "B4 launched 97 times per forward and "
          "B5 48 times per chunk of each group's prefill, nothing else")
    # the first group: the requests admitted first (each group starts its
    # prefill at its own time), prompted by the runtime's first draw
    s0, n0, g0 = runtime.groups[0][:3]
    t_first = min(q.admit_s for q in res16.records)
    first = [q for q in res16.records if q.admit_s == t_first]
    prompt0 = torch.from_numpy(np.random.default_rng(REPLAY_SEED).integers(
        0, V, (n0, s0))).to(dev, torch.int32)
    logits, cache = prefill(runtime.params, {"tokens": prompt0})
    cache = grow_decode_cache(cfg, cache, n0, s0 + g0)
    direct = [torch.argmax(logits[:, :V], -1)[:, None].to(torch.int32)]
    for _ in range(g0 - 1):
        logits, cache = decode(runtime.params, direct[-1], cache)
        direct.append(torch.argmax(logits[:, :V], -1)[:, None]
                      .to(torch.int32))
    direct = torch.cat(direct, 1).cpu().numpy()
    check(len(first) == n0 and all(
        q.prompt_len == s0 and np.array_equal(q.tokens, row[:q.gen_len])
        for q, row in zip(first, direct)),
          "the first group's tokens equal forward_prefill/forward_decode "
          "called directly on the card")
    del runtime, logits, cache
    p_gpu = copy.deepcopy(p_cpu).to(dev)
    cut_toks = {}
    for where, params16 in (("cpu", p_cpu), ("cuda", p_gpu)):
        rt = ExecutedGroupRuntime(cfg=cut, params=params16, seed=CUT_SEED,
                                  device=where)
        cut_toks[where] = rt.run_group(CUT_PROMPT, CUT_STEPS + 1, 1)
    print(f"[16b] {CUT_LAYERS} layers at full width through the runtime: "
          f"{cut_toks['cpu'][0].tolist()} (CPU), "
          f"{cut_toks['cuda'][0].tolist()} (card)")
    check(np.array_equal(cut_toks["cpu"], cut_toks["cuda"])
          and np.array_equal(cut_toks["cpu"], toks_c.numpy()),
          "the cut model's tokens through the runtime: the card's equal "
          "the CPU's, and phase 11's")
    for rec in records:
        rec["online"] = {"launches_simulate_execute":
                         own_launches(sim_launches, rec["name"]),
                         "launches_replay_executed":
                         own_launches(replay_launches, rec["name"])}
    del p_gpu
    t16 = time.perf_counter() - t16
    print(f"[16] phase 16 took {t16:.1f} s ({card})")
    check(t16 <= 60.0, "phase 16 takes at most 60 s")

    # 17. the attention, MLP and MoE families
    t17 = phase17(dev, card, records)
    check(t17 <= 400.0, "phase 17 takes at most 400 s")

    # 18. the train step
    t18 = phase18(dev, card, records)
    check(t18 <= 300.0, "phase 18 takes at most 300 s")

    # 19. the training driver, its checkpoints and faults; the examples
    t19 = phase19(dev, card, records)
    check(t19 <= 200.0, "phase 19 takes at most 200 s")

    # 20. the sharded LM path on one controller
    t20 = phase20(dev, card, records)
    check(t20 <= 200.0, "phase 20 takes at most 200 s")

    # 21. the multi-pod dry run on meta tensors, held against the card
    t21 = phase21(dev, card, records)
    check(t21 <= 120.0, "phase 21 takes at most 120 s")

    print(f"[21] chip_smoke.py took {time.perf_counter() - t_start:.1f} s "
          f"in all")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
