"""What every cell's run shares: the cell's files, the card, the port's
configuration checked against the cell's file, the traced sessions and
their summary, the jax check, and the result line.

Nothing here imports the port at module level: ``run.py`` imports it after
the environment is set and the card is found.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path

from portbench import blocks

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ---------------------------------------------------------------------------
# The cell's files
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic and limits files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((PKG / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((PKG / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, w["chips"], config, traffic, limits, e2e, per_layer)


def load_module(path: Path, name: str):
    """A file of the benchmark's own, imported by its path (drivers and
    metric readers are found by name, and may carry dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    return load_module(PKG / "drivers" / f"{kind}.py", f"portbench_driver_{kind}")


def reader(metric: str):
    return load_module(PKG / "metrics" / f"{metric}.py", "portbench_metric_" + metric.replace(".", "_"))


# ---------------------------------------------------------------------------
# The port's configuration, held to the cell's file
# ---------------------------------------------------------------------------

# the model's own keys (depth, widths of the embedding and the head, dtype) -> the port's ArchConfig field;
# each layer block's keys are its file's (``portbench/blocks/``)
MODEL_KEYS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model", "vocab_size": "vocab",
              "torch_dtype": "dtype", "tie_word_embeddings": "tie_embeddings"}
MODEL_OPTIONS = {"rms_norm_eps": "norm_eps"}  # keys that set an option of the port's
FILE_KEYS = {"arch", "source", "layout", "first_layers", "reduced", "assumed", "deployment", "smoke"}  # not the model's


def arch_config(config: dict):
    """The port's ArchConfig for the cell's file: its registered
    architecture cut to the file's depth, the options the port offers set
    from the file. The check is strict: each of the port's layers must run
    the blocks the file's layer list names (``blocks.mismatch``), every
    key the file states must be owned by the model or by a block it names,
    and every owned value must be the port's. A file with ``"smoke": true``
    (the tests' files) starts from the architecture's tiny CPU preset
    (``ArchConfig.reduced``) and takes the file's sizes."""
    from repro_torch.configs import get_config

    named = blocks.named(config)
    owners = {"the model": MODEL_KEYS | MODEL_OPTIONS}
    options = dict(MODEL_OPTIONS)
    for name, block in named.items():
        owners[name] = block.KEYS | getattr(block, "OPTIONS", {})
        options |= getattr(block, "OPTIONS", {})
    cfg = get_config(config["arch"])
    if config.get("smoke"):
        fields = {k: f for table in owners.values() for k, f in table.items() if isinstance(f, str)}
        cfg = dataclasses.replace(cfg.reduced(), **{f: config[k] for k, f in fields.items() if k in config})
    cfg = dataclasses.replace(cfg, n_layers=config["num_hidden_layers"],
                              **{f: config[k] for k, f in options.items() if k in config})
    cfg = dataclasses.replace(cfg, remat="none")  # serving keeps no activations for a backward
    owned = set().union(*owners.values())
    wrong = [f"{k}: no block that the file names owns it" for k in sorted(set(config) - FILE_KEYS - owned)]
    for owner, table in owners.items():
        for k in sorted(table.keys() & config.keys()):
            port = getattr(cfg, table[k]) if isinstance(table[k], str) else table[k](cfg)
            if config[k] != port:
                wrong.append(f"{k}: file {config[k]!r}, port {port!r} ({owner})")
    want, specs = blocks.layer_list(config), cfg.layer_specs()
    if len(want) != len(specs):
        wrong.append(f"layers: {len(want)} in the file, {len(specs)} in the port")
    for i, (layer, spec) in enumerate(zip(want, specs)):
        if why := blocks.mismatch(layer, spec, cfg):
            wrong.append(f"first difference at layer {i}: " + "; ".join(why))
            break
    for block in named.values():
        wrong += block.refuse(config, cfg) if hasattr(block, "refuse") else []
    if cfg.pad_heads or cfg.encoder_layers or cfg.frontend != "none":
        wrong.append("the port's model has parts the file does not state (padded heads, an encoder or a frontend)")
    if wrong:
        raise SystemExit("the port's configuration is not the cell's file:\n  " + "\n  ".join(wrong))
    return cfg


def check_layout(model, params) -> None:
    """The benchmark's weights have the port's tree, shapes and dtypes."""
    from portbench.weights import shapes

    want = shapes(model.init(0, "meta"))
    got = shapes(params)
    if want != got:
        first = next(((w, g) for w, g in zip(want, got) if w != g), None)
        raise SystemExit(f"the port's parameter layout moved: {len(want)} leaves there, {len(got)} here; "
                         f"first difference (port, benchmark): {first}")


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


def card(chips: int):
    """The cell's first device; exits 3 without the cards it asks for."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s), found {n}; no result", file=sys.stderr)
        raise SystemExit(3)
    return torch.device("cuda", 0)


def device_info(dev, chips: int) -> dict:
    import torch

    if dev.type != "cuda":  # the tests' runs on the host: no device number is read there
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


class Mark:
    """A point on the device's timeline: a CUDA event, or the host clock
    for the tests' runs on the host."""

    def __init__(self, dev):
        import torch

        self.ev = torch.cuda.Event(enable_timing=True) if dev.type == "cuda" else None
        self.t = None

    def record(self) -> None:
        if self.ev is not None:
            self.ev.record()
        else:
            self.t = time.perf_counter()

    def since(self, w0: "Mark") -> float:
        """Seconds from ``w0`` to this mark (after a synchronise)."""
        return w0.ev.elapsed_time(self.ev) / 1e3 if self.ev is not None else self.t - w0.t


def say(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark's process must
    not hold: jax, jaxlib, flax and the JAX package, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------


def p95(values: list) -> float:
    """The 95th percentile (inclusive quantiles, as statistics gives them)."""
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=20, method="inclusive")[18])


# ---------------------------------------------------------------------------
# Traced sessions
# ---------------------------------------------------------------------------


def _union(intervals: list) -> tuple:
    """(covered length, merged intervals) of [start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def traced(fn, dev, label: str):
    """Run ``fn()`` once under ``torch.profiler`` (CPU and CUDA activity),
    between two synchronisations; keep only a summary, in memory: the
    window's host seconds, the device's busy seconds (the union of every
    device operation's interval inside the window), device microseconds and
    launches by kernel name, the idle gaps by the harness span (or else
    the host operation) that was open at the gap's middle, and the port's
    launch counters over the session. Returns (fn's result, summary)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import ops

    before = ops.launch_counts()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        sync(dev)
        t0 = time.perf_counter()
        with record_function("portbench.window"):
            out = fn()
            sync(dev)
        window = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in ops.launch_counts().items() if v - before[k]}
    events = prof.events()
    on_device = lambda e: str(getattr(e, "device_type", "")).endswith("CUDA")  # noqa: E731
    win = next(e for e in events if e.name == "portbench.window" and not on_device(e))
    w0, w1 = win.time_range.start, win.time_range.end
    dev_ev, host_ev = [], []
    for e in events:
        if e.name.startswith("portbench."):  # the harness's spans, on the host and as the device's annotations
            if not on_device(e) and e.name != "portbench.window":
                host_ev.append(e)
            continue
        if on_device(e):
            s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if t > s:
                dev_ev.append((e.name, s, t))
        else:
            host_ev.append(e)
    busy_us, merged = _union([(s, t) for _, s, t in dev_ev])
    kernels: dict = {}
    for name, s, t in dev_ev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += t - s
        k[1] += 1
    gaps: dict = {}
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    spans = [e for e in host_ev if e.name.startswith("portbench.")]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        open_ = [e for e in spans if e.time_range.start <= mid < e.time_range.end]
        if not open_:
            open_ = [e for e in host_ev if e.time_range.start <= mid < e.time_range.end]
        inner = min(open_, key=lambda e: e.time_range.end - e.time_range.start) if open_ else None
        name = inner.name if inner else "host (no recorded op)"
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    return out, {"label": label, "window_s": window, "trace_window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
                 "kernel_us": kernels, "gaps": gaps, "launches": launches}


def kernel_time_s(summary: dict, patterns) -> tuple:
    """(device seconds, launches) of the kernels whose names contain any of
    ``patterns``."""
    us, n = 0.0, 0
    for name, (t, c) in summary["kernel_us"].items():
        if any(p in name for p in patterns):
            us += t
            n += c
    return us / 1e6, n


def merge_summaries(summaries: list) -> dict:
    """One summary of several sessions of one phase."""
    out = {"label": summaries[0]["label"], "window_s": 0.0, "trace_window_s": 0.0, "busy_s": 0.0,
           "kernel_us": {}, "gaps": {}, "launches": {}}
    for s in summaries:
        for k in ("window_s", "trace_window_s", "busy_s"):
            out[k] += s[k]
        for name, (t, c) in s["kernel_us"].items():
            k = out["kernel_us"].setdefault(name, [0.0, 0])
            k[0] += t
            k[1] += c
        for name, t in s["gaps"].items():
            out["gaps"][name] = out["gaps"].get(name, 0.0) + t
        for name, c in s["launches"].items():
            out["launches"][name] = out["launches"].get(name, 0) + c
    return out


def breakdown(summaries: dict) -> dict:
    """The contract's breakdown: the ten device operations that took most
    time, and the ten largest idle totals by what the host was doing, over
    every traced phase."""
    ops_t: dict = {}
    gaps: dict = {}
    for s in summaries.values():
        for name, (t, _) in s["kernel_us"].items():
            ops_t[name] = ops_t.get(name, 0.0) + t / 1e6
        for name, t in s["gaps"].items():
            key = f"{s['label']}: {name}"
            gaps[key] = gaps.get(key, 0.0) + t
    top = sorted(ops_t.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], t] for n, t in top], "idle_gaps": [[n[:160], t] for n, t in idle]}


def write_summary(cell: str, seed: int, summaries: dict) -> Path:
    """The traced run's summary, in the run's TMPDIR (never a chrome trace)."""
    d = Path(os.environ.get("TMPDIR", "/tmp")) / "portbench"
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{cell}-{seed}-trace-summary.json"
    path.write_text(json.dumps(summaries, indent=1, sort_keys=True))
    return path


# ---------------------------------------------------------------------------
# The result
# ---------------------------------------------------------------------------


def judge(checks: dict) -> bool:
    """Every compared number within its limit (a number that is not finite
    fails)."""
    return all(v == v and abs(v) != float("inf") and v <= lim for v, lim in checks.values())


def emit(result: dict, checks: dict) -> None:
    """Print each compared number beside its limit as the last lines of
    standard error, then the result line, its ``checks`` last, as the last
    line of standard output."""
    for name, (v, lim) in checks.items():
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    print(json.dumps(result), flush=True)
