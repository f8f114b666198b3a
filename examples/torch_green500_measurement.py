"""The paper's Green500 measurement (§3-4) on the PyTorch/CUDA port's
power engine (the JAX package's ``examples/green500_measurement.py``):
compose the 56-node cluster layer by layer, simulate the Linpack run into
a PowerTrace, and apply the three measurement levels plus the Level-1
exploit.  Then a smoke Linpack on this port's device, its GFLOP/s over
the H100 table's compute-bound watts.

  PYTHONPATH=src python examples/torch_green500_measurement.py
  PYTHONPATH=src python examples/torch_green500_measurement.py --device cpu

The L-CSC numbers are the calibrated S9150 model's, as in the JAX
package; the H100's watts are its table's, modelled: nothing here reads
the card's power.
"""
import argparse

import numpy as np

from repro_torch.configs.hpl import SMOKE_HPL
from repro_torch.device import resolve_device
from repro_torch.hpl import linpack_run
from repro_torch.power import (H100_SXM, OperatingPoint, SyntheticHPL,
                               evaluate_operating_point, lcsc_cluster,
                               level1_exploit, measure_efficiency, simulate)
from repro_torch.power.green500 import (extrapolation_error,
                                        node_efficiencies,
                                        select_median_nodes)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the smoke Linpack (default cuda)")
    dev = resolve_device(ap.parse_args(argv).device)

    # the composed model at the published operating point: GPU -> node
    # (host + 4xS9150 + fans + PSU curve) -> rack -> cluster (+ switches)
    op = OperatingPoint.green500()
    cluster = lcsc_cluster()
    node_gf, node_w = evaluate_operating_point(op)
    comps = cluster.component_watts(op)
    print(f"node:  {node_gf:.0f} GFLOPS @ {node_w:.1f} W  "
          f"(gpu {comps['gpu']/56:.0f} + host {comps['host']/56:.0f} + "
          f"fan {comps['fan']/56:.1f} + psu_loss {comps['psu_loss']/56:.1f})")
    kw = sum(w for k, w in comps.items() if k != "network") / 1000
    print(f"model: 56 nodes -> {node_gf*56/1000:.1f} TFLOPS @ {kw:.2f} kW "
          f"= {node_gf/node_w*1000:.1f} MFLOPS/W "
          f"(+{comps['network']:.0f} W of switches)")
    print("paper:  56 nodes -> 301.5 TFLOPS @ 57.20 kW = 5271.8 MFLOPS/W\n")

    # the time-stepped run and the three measurement levels
    tr = simulate(SyntheticHPL(duration_s=1800.0), op, cluster=cluster)
    levels = {}
    for lvl in (1, 2, 3):
        r = measure_efficiency(tr, lvl)
        levels[lvl] = r.mflops_per_w
        print(f"Level {lvl}: {r.mflops_per_w:7.1f} MFLOPS/W   ({r.notes})")
    ex = level1_exploit(tr)
    l3 = measure_efficiency(tr, 3)
    print(f"L1 exploit: {ex.mflops_per_w:7.1f} MFLOPS/W  "
          f"(+{ex.mflops_per_w/l3.mflops_per_w-1:.1%} over L3 — the paper "
          f"showed up to +30% and the v2.0 methodology now forbids it)\n")

    rng = np.random.default_rng(0)
    effs = node_efficiencies(rng, 7)
    print("7 sampled nodes [MFLOPS/W]:",
          ", ".join(f"{e:.1f}" for e in effs))
    sel = select_median_nodes(effs, 2)
    print(f"median nodes selected: {sel}; extrapolation error "
          f"{extrapolation_error(effs):.2%} (paper: <1%)\n")

    # this port's device: a smoke Linpack (the GEMM kernel on the card)
    hpl = linpack_run(SMOKE_HPL, device=dev)
    watts = H100_SXM.idle_w + H100_SXM.dyn_compute_w
    print(f"{dev} Linpack n={hpl.n}: {hpl.gflops:.2f} GFLOPS, residual "
          f"{hpl.residual:.3g} (passed={hpl.passed}); at the "
          f"{H100_SXM.name} table's compute-bound {watts:.0f} W (modelled): "
          f"{hpl.gflops / watts * 1000:.2f} MFLOPS/W")
    return {"levels": levels, "exploit": ex.mflops_per_w, "hpl": hpl}


if __name__ == "__main__":
    main()
