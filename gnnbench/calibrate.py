"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own size (not run by the benchmark's own runs).

    python3 gnnbench/calibrate.py --workload <cell> --seeds 11,12,... \\
        [--control_seeds 11,12,13] [--out calib.jsonl]

For every seed: the cell's set-up up to its first window (the data, the
program, the fill, the window's K steps through ``train_window``), the program
freed, then the reference; prints the program's compared numbers. For the
control seeds also: the control, the reference computed with its matmuls
in TF32 (the precision below the configuration's f32 with TF32 off) in the
program's place, and the fault of half of the batch left out (the loss's
mean over the first half of the seeds), the reference in the program's
place. One JSON line per seed and kind, to standard output and ``--out``.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _ints(s: str) -> list:
    return [int(x) for x in s.split(",") if x]


def readings(cell, seed: int, control: bool, device) -> list:
    """[(kind, numbers)] of one seed: "program", and with ``control``
    "control_tf32" and "fault_half_batch"."""
    from gnnbench import cell as C
    from gnnbench.reference import check

    bench = C.Bench(cell, seed % (1 << 63), device)
    bench.setup(warmup=False)
    bench.free_program()
    n, full = int(cell.cfg["num_nodes"]), cell.traffic["fill"] == "all"
    ref = check.follow(cell, bench.data, bench.seed, bench.vec, device)
    out = [("program", check.numbers(bench.program, ref, n, full))]
    out.append(("program_leaves", {
        "grad": check.leaf_gaps(bench.program["grad"], ref["grad"]),
        "update": check.leaf_gaps(bench.program["update"], ref["update"],
                                  check.moved(ref)),
        "loss": bench.program["loss"], "ref_loss": ref["loss"]}))
    if control:
        for kind, kw in (("control_tf32", {"precision": "tf32"}),
                         ("fault_half_batch", {"half_batch": True})):
            other = check.as_program(check.follow(
                cell, bench.data, bench.seed, bench.vec, device, **kw))
            out.append((kind, check.numbers(other, ref, n, full)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, required=True)
    p.add_argument("--control_seeds", type=_ints, default=[])
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch

    from gnnbench import registry

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = registry.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        for kind, nums in readings(cell, seed, seed in args.control_seeds,
                                   device):
            line = json.dumps({"cell": cell.name, "seed": seed,
                               "kind": kind, "numbers": nums,
                               "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
