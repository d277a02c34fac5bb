"""One run of one cell of the port's benchmark.

  python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell (``BENCHMARK.json``'s workload)
names a configuration file and a traffic file; the traffic's ``kind`` names
the driver (``portbench/drivers/<kind>.py``), which sets up the port
(``src/repro_torch``) on the card, measures for ``--seconds`` and compares
what the timed path produced with the plain reference. With ``--trace 0``
the result line carries the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics, each read by ``portbench/metrics/<metric>.py`` from
the run's spans and its traced sessions (``torch.profiler``, summarised in
memory; only the summary is written, under ``$TMPDIR/portbench/``).

Exits 3 without the CUDA devices the cell asks for, and 4 if the process
holds jax, jaxlib, flax or the JAX package once the window has closed; in
either case it prints no result. The port's kernels build into
``build/repro_torch_kernels/`` inside the checkout, on its first run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """The port's sources and the benchmark on the path; every cache that a
    library might write at a fixed path inside the checkout; one host thread
    for PyTorch's and OpenMP's CPU pools (threads spinning beside the one
    that dispatches to the card widened the spread of a training loop's
    rate and set-up on an H100 host: 1.66 % against 1.04 %, 17 % against 7 %)."""
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    cache = ROOT / "build" / "portbench-cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from portbench import harness

    cell = harness.load_cell(args.workload)
    dev = harness.card(cell.chips)
    harness.say(f"imports and the card {time.perf_counter() - T_START:.2f} s")
    out = harness.driver(cell.traffic["kind"]).run(cell, args.seed, args.seconds, bool(args.trace), dev, T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process holds {found} after the window; no result", file=sys.stderr)
        return 4
    return report(cell, args, out)


def report(cell, args, out: dict) -> int:
    from portbench import harness

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if args.trace:
        ctx = dict(out["layer"], profile=out["profile"], cell=cell.name)
        values = {m["name"]: harness.reader(m["name"]).read(ctx) for m in cell.per_layer}
        values = {k: v for k, v in values.items() if v is not None}
    else:
        # a quantity split over cells (``<base>.<part>``) is the driver's under its base name
        e2e = out["end_to_end"]
        values = {m["name"]: e2e.get(m["name"], e2e.get(m["name"].split(".")[0])) for m in cell.end_to_end}
        values = {k: v for k, v in values.items() if v is not None}
    device = dict(out["device"])
    result = {"correct": harness.judge(out["checks"]), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()}, "device": device}
    if args.trace:
        phases = out["profile"]
        device["busy_s"] = sum(s["busy_s"] for s in phases.values())
        device["window_s"] = sum(s["trace_window_s"] for s in phases.values())
        result["breakdown"] = harness.breakdown(phases)
        path = harness.write_summary(cell.name, args.seed, phases)
        print(f"portbench: trace summary in {path}", file=sys.stderr)
    for name, v in out.get("readings", {}).items():
        if name not in out["checks"]:
            print(f"reading {name}: {v!r} (not compared)", file=sys.stderr)
    harness.emit(result, out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
