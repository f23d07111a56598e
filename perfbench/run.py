"""Run one benchmark cell once on the card this process sees.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit, which also end standard error).  ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer ones from a profiled
slice of the window.  It exits non-zero, printing no result, without a CUDA
card (or with fewer than the cell asks for), without the program in the
checkout, or when JAX or the JAX package got loaded.  Kernel build and
compile caches stay inside the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def fail(msg: str, code: int = 2) -> int:
    print(f"perfbench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        return fail(f"the program (src/repro_torch) is not in {ROOT}")
    cache = ROOT / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from perfbench import harness

    w = harness.cell(harness.benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        return fail(f"{args.workload} needs {w['chips']} CUDA card(s); "
                    f"this process sees {torch.cuda.device_count()}")
    result, _ = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                 "cuda", T_START)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        return fail(f"modules the benchmark must not load were loaded: {bad}", 3)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
