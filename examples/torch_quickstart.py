"""Quickstart on the PyTorch port: the Koalja Workspace in 60 lines.

The circuit of ``examples/quickstart.py`` (the paper's fig. 5) on
``repro_torch``: built from the wiring DSL (one constructor), fed sensor
samples as tensors on the device, pulled make-style (watch the cache hits),
and its final artifact's three provenance stories printed, all from one
typed entry point.

  PYTHONPATH=src python examples/torch_quickstart.py                 # on the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.models.common import resolve_device
from repro_torch.workspace import Workspace

# --- plugin user code (what a Koalja user writes) ---------------------------


def learn_tf(**inputs):
    data = inputs["in"]
    return {"model": {"w": torch.mean(data), "version": 1}}


def server(model):
    return {"lookup": {"scale": model["w"] * 2}}


def convert(**inputs):
    windows = inputs["in"]  # sliding window [10/2]: last 10 samples
    return {"json": {"series": [float(torch.sum(w)) for w in windows]}}


def predict(json, lookup):
    return {"result": float(sum(json["series"])) * lookup["scale"]}


WIRING = """
[tfmodel]
(in) learn-tf (model)
(model) server (lookup)
(in[10/2]) convert (json)
(json, lookup) predict (result)
"""


def build(device) -> Workspace:
    """The circuit, fed the reference's 14 samples (``RandomState(0)``) as
    tensors on ``device``."""
    ws = Workspace.from_wiring(
        WIRING,
        {"learn-tf": learn_tf, "server": server, "convert": convert, "predict": predict},
        modes={"predict": "swap_new_for_old"},
    )
    # reactive mode: sensor samples arrive at the edge
    rng = np.random.RandomState(0)
    for _ in range(14):
        sample = torch.from_numpy(rng.randn(8)).to(device)
        ws.push("learn-tf", **{"in": sample})
        ws.push("convert", **{"in": sample})
    return ws


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ws = build(resolve_device(args.device))

    # result-oriented: name the target, get the payload (make semantics)
    result = ws.pull("predict")
    print("result:", float(result["result"]))

    # pulling again with nothing new -> cache hits, no recompute
    execs_before = {n: t.executions for n, t in ws.pipeline.tasks.items()}
    ws.pull("predict")
    assert {n: t.executions for n, t in ws.pipeline.tasks.items()} == execs_before
    print("pull with no new data: zero re-executions (make semantics)")

    # the three stories (paper §III.C), straight off the result handle
    result_av = result.av("result")
    print("\n--- story 1: traveller log of the result artifact ---")
    for stamp in ws.traveller_log(result_av):
        print(f"  {stamp['task']:>10s} {stamp['event']:<9s} sw={stamp['software_version']}")
    print("\n--- story 2: checkpoint visitor log (predict) ---")
    for v in ws.visitor_log("predict")[-4:]:
        print(f"  {v['event']:<9s} av={v['av_uid']} {v['note']}")
    print("\n--- story 3: design map ---")
    print(ws.design_map_text())
    print("\nmetadata overhead:", ws.registry.overhead_bytes(), "bytes")
    return {"result": float(result["result"]), "executions": execs_before, "design_map": ws.design_map_text()}


if __name__ == "__main__":
    main()
