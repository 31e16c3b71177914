"""Run one cell of the benchmark of the PyTorch + CUDA port.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is the result (JSON); the
numbers `correct` was decided on are the last lines of standard error.
"""
import time

T_PROC0 = time.monotonic()      # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


def _environment() -> None:
    """Fixed kernel-cache directories inside the checkout; none of the
    program's debug switches (SPTPU_*) carried in from outside."""
    for key in [k for k in os.environ if k.startswith("SPTPU_")]:
        del os.environ[key]
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, ROOT)

    import importlib

    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.workload["chips"]:
        print(f"{args.workload} needs {cell.workload['chips']} CUDA "
              f"device(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    driver = importlib.import_module(
        f"benchmark.harness.{cell.workload['driver']}")
    return driver.run(cell, seed=args.seed, seconds=args.seconds,
                      trace_on=bool(args.trace),
                      device=torch.device("cuda", 0), t_proc0=T_PROC0)


if __name__ == "__main__":
    sys.exit(main())
