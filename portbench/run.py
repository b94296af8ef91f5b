"""One run of one cell of the port's benchmark:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  Prints the run's progress and, as its last lines, each number the
check compared beside its limit on standard error, and one JSON object
as the last line of standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``setup_parts``, ``device``, with ``--trace
1`` also ``breakdown``, and ``checks`` last).  Exits with 2 and prints no result
without enough CUDA devices, and with 3 if a JAX module or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Every build and kernel cache inside the checkout, at a fixed path (the
# port's own nvcc build goes to build/repro_torch/ beside them).
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / "build" / "portbench" / sub))
sys.path.insert(0, str(ROOT))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness
    bench = harness.Bench(ROOT)
    chips = int(bench.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"this cell needs {chips} CUDA device(s); found "
                    f"{torch.cuda.device_count()}: no result")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    harness.log(f"[device] {_power_limit()}; torch {torch.__version__}")
    out, run = harness.run_cell(bench, args.workload, args.seed,
                                args.seconds, bool(args.trace), T_START)
    bad = harness.loaded_forbidden()
    if bad:
        harness.log(f"modules of {bad} were loaded in this process: no "
                    "result")
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(run.peak_bytes)}
    if run.trace is not None:
        device.update(busy_s=run.trace["busy_s"],
                      window_s=run.trace["window_s"])
    checks = out.pop("checks")
    result = {**out, "device": device, "checks": checks}
    for name, c in checks.items():
        harness.log(f"[limit] {name} {c['value']!r} limit {c['limit']!r} "
                    f"{'ok' if c['value'] <= c['limit'] else 'OVER'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
