"""Run one cell of the benchmark on the CUDA card(s) of this machine.

    python3 lpbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints progress and, as its last lines, each number compared beside its
limit on standard error; the last line of standard output is the
result: one JSON object with `correct`, `attempted`, `failed`,
`metrics`, `device` (and with `--trace 1` `breakdown`), and `checks`,
the numbers compared, last. Exits non-zero, printing no result, without
CUDA or with fewer cards than the cell needs, or when `jax`, `jaxlib`,
`flax` or `highs_tpu` is loaded once the window has closed.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave no answer"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from lpbench import harness
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        log("no CUDA card: the benchmark measures the program on the card "
            "and has no CPU mode")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{torch.cuda.device_count()} CUDA card(s), the cell needs "
            f"{cell.chips}")
        return 2
    import highs_tpu_torch  # noqa: F401  the system under test
    device = torch.device("cuda", 0)
    if args.trace:
        print(f"card: {card_line()}", flush=True)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device, STARTED, log)
    found = harness.forbidden_modules()
    if found:
        log(f"loaded after the window, and forbidden: {found}")
        return 3
    result["device"]["kind"] = torch.cuda.get_device_name(device)
    checks = result.pop("checks")
    result["checks"] = checks  # the numbers compared come last
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
