"""The paper's workload on the PyTorch/CUDA port: invert the
Wilson-Dirac operator with CG on a thermal lattice through the
hand-written D-slash kernels, with the energy plan the framework derives
for it (memory-bound -> deep clock derate) and the plain-vs-even-odd
mixed-precision energy-to-solution comparison (the JAX package's
``examples/lqcd_cg.py``).

  PYTHONPATH=src python examples/torch_lqcd_cg.py              # the card
  PYTHONPATH=src python examples/torch_lqcd_cg.py --device cpu

On the card the full D-slash (B2) and the even-odd hop (B1) are the CUDA
kernels, checked here against their plain versions; on the CPU both
sides are the plain versions.  The watts are the H100 table's, modelled:
nothing here reads the card's power.
"""
import argparse
import time

import torch

from repro_torch.config import EnergyConfig
from repro_torch.core.energy import H100_HW, solver_energy
from repro_torch.core.energy.dvfs import plan_frequency
from repro_torch.device import resolve_device
from repro_torch.kernels.dslash.ops import dslash_half_op, dslash_op
from repro_torch.kernels.dslash.ref import (dslash_eo_split_ref,
                                            dslash_split_ref, from_split,
                                            to_split)
from repro_torch.lqcd import (dslash_bytes_per_site, dslash_flops_per_site,
                              eo_pack, pack_gauge, random_su3_field,
                              solve_wilson, solve_wilson_eo)
from repro_torch.roofline import hw


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    dev = resolve_device(ap.parse_args(argv).device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    lattice = (8, 8, 8, 8)        # thermal (T > 0) smoke lattice
    kappa = 0.12
    gen = torch.Generator(dev).manual_seed(0)
    U = random_su3_field(gen, lattice, dev)
    b = torch.complex(torch.randn(lattice + (4, 3), generator=gen,
                                  device=dev),
                      torch.randn(lattice + (4, 3), generator=gen,
                                  device=dev))

    # the kernels (on the card) against their plain versions
    err_full = float((dslash_op(U, b) - from_split(dslash_split_ref(
        to_split(U), to_split(b)))).abs().max())
    U_e, U_o = pack_gauge(U)
    b_e = eo_pack(b, 0)
    err_eo = float((dslash_half_op(U_e, U_o, b_e, 0) - from_split(
        dslash_eo_split_ref(to_split(U_o), to_split(U_e), to_split(b_e),
                            0))).abs().max())
    print(f"D-slash kernels vs plain on {where}: full (B2) max err "
          f"{err_full:.2e}, even-odd (B1) max err {err_eo:.2e}")

    _sync(dev)
    t0 = time.perf_counter()
    res = solve_wilson(U, b, kappa, tol=1e-6, max_iters=1000)
    _sync(dev)
    dt = time.perf_counter() - t0
    vol = 8 ** 4
    # each CG iteration applies D-slash twice (M and M-dagger)
    gflops = 2 * int(res.iters) * vol * dslash_flops_per_site() / dt / 1e9
    print(f"CG converged={bool(res.converged)} iters={int(res.iters)} "
          f"rel_resid={float(res.rel_residual):.2e} ({dt:.2f}s, "
          f"{gflops:.2f} GFLOPS on {where})")

    # the paper's solver-level optimization: even-odd Schur CG with a
    # bf16 inner / f32 outer defect-correction loop (CL2QCD strategy)
    _sync(dev)
    t0 = time.perf_counter()
    eo = solve_wilson_eo(U, b, kappa, tol=1e-6, max_iters=1000,
                         inner_dtype=torch.bfloat16)
    _sync(dev)
    dt_eo = time.perf_counter() - t0
    print(f"EO mixed CG converged={eo.converged} normal_ops={eo.iters}"
          f"+{eo.outer_iters} (plain: {int(res.iters)}) "
          f"rel_resid={eo.rel_residual:.2e} ({dt_eo:.2f}s)")
    e_plain = solver_energy("plain_f32", vol, int(res.iters), hw=H100_HW)
    e_eo = solver_energy("eo_bf16", vol, eo.iters, outer_ops=eo.outer_iters,
                         inner_real_bytes=2, even_odd=True, hw=H100_HW)
    print(f"energy-to-solution ({H100_HW.name} table, modelled): "
          f"plain={e_plain.energy_j:.3e} J"
          f" @ {e_plain.gflops_per_w:.2f} GFLOPS/W -> "
          f"eo_bf16={e_eo.energy_j:.3e} J @ {e_eo.gflops_per_w:.2f} GFLOPS/W"
          f" ({1 - e_eo.energy_j / e_plain.energy_j:.0%} saved)")

    # the paper's C5: D-slash is memory-bound -> the DVFS plan derates.
    # The H100's rates: the kernels compute in f32 on the CUDA cores
    ai = dslash_flops_per_site() / dslash_bytes_per_site(4)
    compute_s = 1.0 / hw.PEAK_F32_FLOPS
    memory_s = (1.0 / ai) / hw.HBM_BW
    plan = plan_frequency(compute_s, memory_s, 0.0, flops_per_step=1e12,
                          cfg=EnergyConfig(mode="efficiency"))
    print(f"energy plan: dominant={plan.dominant} freq={plan.freq_scale:.2f}"
          f" power={plan.power_w:.0f}W (H100 table, modelled) "
          f"perf_loss={plan.perf_loss:.3%} (paper: <1.5%)")
    return {"err_full": err_full, "err_eo": err_eo, "plain": res, "eo": eo,
            "plan": plan}


if __name__ == "__main__":
    main()
