"""Run one cell of ``BENCHMARK.json`` once, on the card, and print its
result as the last line of standard output.

    python3 gnnbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics (host clock, ending in ``torch.cuda.synchronize()``); ``--trace 1``
its per-layer metrics (an unprofiled stretch of ``--seconds``, then a span
of the traffic's ``trace_windows`` windows under ``torch.profiler``).
Every run checks what its first window of K steps produced against the
plain reference once the window has closed (``gnnbench/reference/check.py``),
and prints each number compared beside its limit: as the last lines of
standard error and, last, in the result line. An earlier line of standard
output names the card and its SM clock, power draw and power limit,
sampled by ``nvidia-smi`` beside the window.

Exits with another code than 0, and prints no result, without a CUDA card
(or fewer than the cell asks for), when a module of JAX or of the JAX
package is loaded once the window has closed, and on any failure. The
build caches of the program and of PyTorch live in ``.gnnbench_cache/``
inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".gnnbench_cache")
#: build and kernel caches, each at a fixed path inside the checkout
CACHE_DIRS = (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
              ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv"),
              ("TORCHINDUCTOR_CACHE_DIR", "inductor"))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class SmiSampler:
    """``nvidia-smi`` sampling the SM clock and the power draw every
    second while the window runs (nothing where it cannot be started)."""

    QUERY = "timestamp,clocks.sm,power.draw,power.limit"

    def __init__(self):
        self.proc, self.rows = None, []

    def __enter__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.QUERY}",
                 "--format=csv,noheader,nounits", "-i", "0", "-lms", "1000"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
        return self

    def __exit__(self, *exc):
        if self.proc is None:
            return
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        for line in out.splitlines():
            parts = [s.strip() for s in line.split(",")]
            if len(parts) == 4:
                self.rows.append(parts)

    def line(self, card: str, t0: float, t1: float) -> str:
        """The samples taken between the epoch seconds t0 and t1."""
        def when(stamp: str) -> float:
            try:
                return time.mktime(time.strptime(stamp.split(".")[0],
                                                 "%Y/%m/%d %H:%M:%S"))
            except ValueError:
                return -1.0

        rows = [r for r in self.rows if t0 - 1 <= when(r[0]) <= t1 + 1]

        def col(i):
            vals = []
            for r in rows:
                try:
                    vals.append(float(r[i]))
                except ValueError:
                    pass
            if not vals:
                return "not measured"
            vals.sort()
            return (f"median {vals[len(vals) // 2]} (min {vals[0]}, max "
                    f"{vals[-1]}, {len(vals)} samples)")
        return (f"card: {card}; clocks.sm MHz {col(1)}; power.draw W "
                f"{col(2)}; power.limit W {col(3)}")


def main(argv=None) -> int:
    args = parse_args(argv)
    for var, sub in CACHE_DIRS:
        os.environ[var] = os.path.join(CACHE, sub)
    import torch

    from gnnbench import cell as C
    from gnnbench import registry

    cell = registry.load_cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine "
              f"has {have}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = SmiSampler()
    with smi:
        out = C.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         device, T_START)
    if out is None:
        return 3
    result, report, (t0, t1) = out
    print(smi.line(result["device"]["kind"], t0, t1))
    for line in report:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
