"""Command-line entry point (the analog of `mpirun roms < roms_app.in`):

    python -m roms_tpu run config.yaml
    python -m roms_tpu run --case upwelling --nsteps 100 --his his.nc
    python -m roms_tpu cases
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="roms_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run a model case")
    runp.add_argument("yaml", nargs="?", help="YAML run configuration")
    runp.add_argument("--case", default=None)
    runp.add_argument("--nsteps", type=int, default=None)
    runp.add_argument("--his", default=None, help="history NetCDF path")
    runp.add_argument("--nhis", type=int, default=10)
    runp.add_argument("--rst", default=None, help="restart checkpoint path")
    runp.add_argument("--nrst", type=int, default=0)
    runp.add_argument("--ninfo", type=int, default=10)

    sub.add_parser("cases", help="list available model cases")

    args = ap.parse_args(argv)

    from .utils.yamlcfg import CASES, build_from_yaml, build_from_dict
    from .utils import compcache

    if args.cmd == "cases":
        for name in sorted(CASES):
            print(name)
        return 0

    compcache.enable()
    if args.yaml:
        cfg, grid, state0, ffn, opts = build_from_yaml(args.yaml)
    else:
        doc = {"case": args.case or "upwelling",
               "nsteps": args.nsteps or 10}
        cfg, grid, state0, ffn, opts = build_from_dict(doc)
    if args.nsteps is not None:
        opts["nsteps"] = args.nsteps
    if args.his:
        opts.setdefault("his_file", args.his)
        opts.setdefault("nhis", args.nhis)
    if args.rst:
        opts.setdefault("rst_file", args.rst)
        opts.setdefault("nrst", args.nrst)

    if opts.get("mode") == "2d":
        print("2D-only case: use roms_tpu.ops.step2d.step_2d_only directly",
              file=sys.stderr)
        return 2

    from .driver import Simulation

    print(f" roms_tpu: case={cfg.name} grid={cfg.Lm}x{cfg.Mm}x{cfg.N} "
          f"dt={cfg.dt} ndtfast={cfg.ndtfast} nfast={cfg.nfast}")
    print(f"    STEP   TIME(d)  diagnostics")
    sim = Simulation(cfg, grid, state0, ffn,
                     his_file=opts.get("his_file"),
                     nhis=int(opts.get("nhis", 0) or 0),
                     rst_file=opts.get("rst_file"),
                     nrst=int(opts.get("nrst", 0) or 0),
                     avg_file=opts.get("avg_file"),
                     navg=int(opts.get("navg", 0) or 0),
                     dia_file=opts.get("dia_file"),
                     ndia=int(opts.get("ndia", 0) or 0),
                     qck_file=opts.get("qck_file"),
                     nqck=int(opts.get("nqck", 0) or 0),
                     ndef_his=int(opts.get("ndef_his", 0) or 0),
                     ninfo=int(opts.get("ninfo", 10) or 0))
    sim.run(int(opts["nsteps"]))
    sim.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
