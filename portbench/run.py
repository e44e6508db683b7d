"""Run one cell of the port's benchmark on this machine's card.

    python3 -m portbench.run --workload 576w.mine --seed 7 --seconds 51 --trace 0

from the root of a checkout that holds ``BENCHMARK.json``. Prints, as the
last line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``, then ``checks`` (each number of the output check beside its
limit), which also end standard error. Exits 2 without a result where no
CUDA card (or too few) is present, and 3 where JAX or the JAX package got
loaded. ``--control 1`` (calibration only) also reads the float8 control
and prints, as ``control_correct``, the same verdict on it.

The process runs with a fixed ``PYTHONHASHSEED``, so that every run lays
out its dicts and sets alike: started without it, it starts itself again
with it, and set-up is timed from the first start.
"""

import time

T_START = time.perf_counter()  # noqa: E402 - set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "orbax", "dvdx_tpu")
HASH_SEED = "0"
START_ENV = "PORTBENCH_T_START"  # the first start's clock, handed to the second
T_START = float(os.environ.pop(START_ENV, T_START))


def with_fixed_hash_seed() -> None:
    """Start this command again with ``PYTHONHASHSEED`` fixed, unless it
    already is. ``perf_counter`` is the system's monotonic clock, so the
    first start's reading stays valid in the second process."""
    if os.environ.get("PYTHONHASHSEED") == HASH_SEED:
        return
    env = dict(os.environ, PYTHONHASHSEED=HASH_SEED, **{START_ENV: repr(T_START)})
    sys.stdout.flush()
    sys.stderr.flush()
    os.execve(sys.executable, [sys.executable, "-m", "portbench.run", *sys.argv[1:]], env)


def loaded_banned() -> list:
    """Modules whose whole top-level name is JAX's, its libraries' or the
    JAX package's (``dvdx_tpu_torch`` is not ``dvdx_tpu``)."""
    return sorted({name for name in sys.modules if name.split(".")[0] in BANNED})


def card_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, which a
    share of the card's peak is read beside."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({type(e).__name__})"


def main(argv=None) -> int:
    if argv is None:
        with_fixed_hash_seed()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open("BENCHMARK.json") as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['name']} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from portbench.harness import run_cell

    out = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                   root=os.getcwd(), control=bool(args.control),
                   log=lambda s: print(s, file=sys.stderr, flush=True))
    banned = loaded_banned()
    if banned:
        print(f"portbench: the run loaded {banned}", file=sys.stderr)
        return 3
    readings, checks = out.pop("readings"), out.pop("checks")
    print(f"portbench: card {card_and_power_limit()}", file=sys.stderr)
    print("portbench readings " + json.dumps(readings), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    line = {"correct": out.pop("correct"), **out, "checks": checks}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
