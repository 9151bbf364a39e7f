"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program (``src/``).  Needs
a CUDA device (as many as the cell's ``chips``); exits non-zero and prints
no result without one, without the program, or when JAX or the JAX package
is loaded after the window.  The last line of standard output is the
result (``perfbench/README.md``).
"""
import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Before torch is imported: one thread a math library, and every build
    and kernel cache at a fixed path inside the checkout (the port's nvcc
    libraries already live in ``build/repro_torch_kernels``)."""
    # one process with few threads: the engine's host work is serial Python,
    # so one thread keeps a run's load on a shared host to one core
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    build = ROOT / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["REPRO_TORCH_TUNING_CACHE"] = str(build / "tuning_cache.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no program: {ROOT / 'src' / 'repro_torch'} is missing", file=sys.stderr)
        return 2
    _environment()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench.harness import runner, spec

    bench = spec.benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    limits = spec.limits(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    rec = runner.measure(bench, args.workload, args.seed, args.seconds,
                         bool(args.trace), torch.device("cuda:0"), T_PROC0)
    bad = runner.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package is loaded: sys.modules holds {bad}", file=sys.stderr)
        return 4
    runner.emit(bench, rec, bool(args.trace), limits)
    return 0


if __name__ == "__main__":
    sys.exit(main())
