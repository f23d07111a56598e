"""Frontend smoke CLI: lift one traced workload and simulate it on the host.

Proves the port's real-kernel path end to end::

    PYTHONPATH=src python -m repro_torch.frontend traced_matmul

Lifts the named workload from the port's PyTorch functions (no CUDA), checks
the interval plan validates, runs it on the port's scalar engine and its copy
of the golden engine at one design, prints a JSON report, and fails loudly
(exit 1) on any divergence.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    from repro_torch.frontend.workloads import (DEFAULT_MAXREGCOUNT, TRACED_NAMES,
                                                build_traced_workload)

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("name", nargs="?", default="traced_matmul",
                    choices=TRACED_NAMES)
    ap.add_argument("--design", default="LTRF")
    ap.add_argument("--maxregcount", type=int, default=DEFAULT_MAXREGCOUNT)
    ap.add_argument("--num-warps", type=int, default=16)
    ap.add_argument("--cap", type=int, default=16,
                    help="interval register cap for the plan check")
    ap.add_argument("--asm", action="store_true",
                    help="also print the lifted program")
    args = ap.parse_args(argv)

    from repro_torch.core.intervals import form_register_intervals
    from repro_torch.sim import design_config, simulate
    from repro_torch.sim.golden import golden_simulate

    w = build_traced_workload(args.name, maxregcount=args.maxregcount)
    an = form_register_intervals(w.program, n_cap=args.cap)
    an.validate()
    if args.asm:
        print(w.program.render())

    cfg = design_config(args.design, table2_config=7, num_warps=args.num_warps)
    fast = simulate(w, cfg)
    gold = golden_simulate(w, cfg)
    report = {
        "workload": w.name,
        "instructions_static": w.program.num_instrs(),
        "regs_per_thread": w.regs_per_thread,
        "intervals": len(an.intervals),
        "design": args.design,
        "cycles": fast.cycles,
        "instructions": fast.instructions,
        "ipc": round(fast.ipc, 4),
        "prefetch_ops": fast.prefetch_ops,
        "engines_match": fast == gold,
    }
    print(json.dumps(report, indent=1))
    if fast != gold:
        print("FATAL: engine/golden divergence on traced kernel",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
