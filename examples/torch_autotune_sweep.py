"""Rediscover the paper's Green500 operating point by sweeping the
parameter space (§2–4), then tune the port's own hot paths with the same
machinery (the JAX package's ``examples/autotune_sweep.py``).

  PYTHONPATH=src python examples/torch_autotune_sweep.py [cache.json]
  PYTHONPATH=src python examples/torch_autotune_sweep.py --device cpu

The searches are analytic: nothing is timed.  ``--device`` names the
device the tile and blocking picks are cached for (the card's name, or
``torch-cpu``).  Passing a path persists the winners as a JSON
autotune cache that the ``tuned=True`` paths (``linpack_run``, ``dgemm``)
consult through ``REPRO_TORCH_AUTOTUNE_CACHE``.
"""
import argparse

from repro_torch.autotune import (TuneCache, default_cache,
                                  set_default_cache, tune_dslash_tblock,
                                  tune_operating_point, tuned_config)
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("cache", nargs="?", default=None,
                    help="a JSON file to persist the winners in")
    ap.add_argument("--device", default="cuda",
                    help="torch device the picks are for (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.cache:
        set_default_cache(TuneCache(args.cache))

    print("=== node operating-point sweep (analytic, grid) ===")
    res = tune_operating_point()
    top = sorted((c for c in res.trace
                  if c.feasible and c.perf_gflops >= res.perf_floor_gflops),
                 key=lambda c: -c.mflops_per_w)[:5]
    print(f"{'f_MHz':>6} {'vid':>7} {'fan':>5} {'NB':>5} {'la':>3} "
          f"{'GFLOPS':>8} {'W':>7} {'MFLOPS/W':>9}")
    for c in top:
        p = c.point
        print(f"{p['f_mhz']:6.0f} {p['vid']:7.4f} {p['fan']:5.2f} "
              f"{p['nb']:5d} {p['lookahead']:3d} {c.perf_gflops:8.1f} "
              f"{c.power_w:7.1f} {c.mflops_per_w:9.1f}")
    best = res.best.point
    print(f"\nwinner: {best['f_mhz']:.0f} MHz @ vid {best['vid']}, "
          f"fan {best['fan']:.0%}, NB {best['nb']}, "
          f"lookahead {best['lookahead']}")
    print(f"  {res.best.mflops_per_w:.1f} MFLOPS/W "
          f"(paper: 5271.8), giving up {res.perf_loss:.1%} Linpack "
          f"(paper: ~13–15%)")

    cd = tune_operating_point(method="coordinate")
    print(f"  coordinate descent: same point = {cd.best.point == best}, "
          f"{cd.evaluations} vs {res.evaluations} evaluations\n")

    print(f"=== CUDA kernel + HPL blocking tuning (analytic, {dev}) ===")
    # tuned_config is the cache-backed entry point the tuned=True paths
    # use — going through it here persists the winners
    d = tuned_config("dgemm", (1024, 1024, 1024), device=dev)
    print(f"dgemm 1024^3:  tiles {d}")
    s = tune_dslash_tblock((8, 8, 8, 8))
    print(f"dslash 8^4:    one launch {s.best.point} (nothing to tune)")
    h = tuned_config("hpl", (1024,), device=dev)
    print(f"hpl n=1024:    block {h['block']}, lookahead {h['lookahead']}")
    tuned_config("operating_point", (), device=dev)

    print("\nconsume via the tuned paths, e.g.:")
    print("  linpack_run(HPLConfig(n=1024), tuned=True)")
    print("  dgemm(x, y, tuned=True)")
    if args.cache:
        print(f"\ncache persisted: {args.cache} "
              f"({len(default_cache())} entries)")
    return {"best": best, "coordinate_same": cd.best.point == best,
            "dgemm": d, "hpl": h}


if __name__ == "__main__":
    main()
