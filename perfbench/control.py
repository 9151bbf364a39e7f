"""Readings that set a cell's limit, and the control judged by it: the
program's widest logit gap on many seeds, and the control's (the reference
in fp8, the precision below the configuration's bf16, at the same
positions of the same served requests).

    python3 perfbench/control.py --workload internlm2_decode128 --seconds 30 --seeds 11,12,13

One process (the kernels are built once); each seed is a whole run of the
cell at its own load and window, as ``run.py`` makes it, then both
comparisons.  Each reading goes through the result line's own judgement
with the cell's ``limits/<cell>.json``: the program's has to come out as
correct, the control's as not correct.  A line a seed, then the largest
program reading and the smallest control reading; the exit code is 1 when
a program run is not correct or a control run is.
"""
import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT, _environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    _environment()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from perfbench.harness import runner, spec

    bench = spec.benchmark(ROOT)
    limits = spec.limits(args.workload)
    prog, ctl, wrong = [], [], 0
    for seed in [int(s) for s in args.seeds.split(",")]:
        rec = runner.measure(bench, args.workload, seed, args.seconds, False,
                             torch.device("cuda:0"), time.perf_counter(), control=True)
        res = runner.result(bench, rec, False, limits)
        j = rec["judged"]
        c = runner.result(bench, rec, False, limits, judged=j["control"])
        prog.append(j["max_logit_gap"])
        ctl.append(j["control"]["max_logit_gap"])
        wrong += (not res["correct"]) + bool(c["correct"])
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "control_correct": c["correct"], "tokens": j["tokens"],
                          "requests": j["requests"], "checks": res["checks"],
                          "control_checks": c["checks"], "argmax_agree": j["argmax_agree"],
                          "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                          "setup_split": rec["split"]}), flush=True)
        del rec
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    print(json.dumps({"workload": args.workload, "lower": max(prog), "upper": min(ctl),
                      "limit": limits["max_logit_gap"]["limit"], "program": prog,
                      "control": ctl, "wrong_verdicts": wrong}), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
