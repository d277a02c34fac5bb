"""Wireframing + region audit (paper §III.K / §IV) on the PyTorch port.

The audit of ``examples/wireframe_audit.py`` on ``repro_torch``: ghost
batches (``repro_torch.core.ShapeDtypeStruct``) go through a multi-region
workspace to expose where data WOULD be routed before any real data moves
(the tasks run on meta tensors: no byte is moved, no kernel launched); then
a real batch on the device runs, and region crossings are audited from the
travel documents, including a fenced wire that refuses to carry EU-origin
artifacts ("US data cannot leave the US" enforced and auditable). Link
policy is set fluently on the wires: ``(a["s"] >> b["t"]).region("us")
.fence("eu")``.

  PYTHONPATH=src python examples/torch_wireframe_audit.py                 # on the card
  PYTHONPATH=src python examples/torch_wireframe_audit.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.core import RegionFenceError, ShapeDtypeStruct
from repro_torch.models.common import resolve_device
from repro_torch.workspace import Workspace


def build_workspace(with_exfil: bool = False) -> Workspace:
    ws = Workspace("multi_region")
    sensor = ws.task(
        lambda x: {"eu_raw": x}, name="eu_sensor", inputs=["x"], outputs=["eu_raw"],
        region="eu",
    )
    summarize = ws.task(
        lambda eu_raw: {"summary": torch.mean(eu_raw, dim=0)},
        name="eu_summarize", inputs=["eu_raw"], outputs=["summary"], region="eu",
    )
    aggregate = ws.task(
        lambda summary: {"report": torch.sum(summary)},
        name="hq_aggregate", inputs=["summary"], outputs=["report"], region="us",
    )
    (sensor["eu_raw"] >> summarize["eu_raw"]).region("eu")
    # only summaries cross the region boundary (transport avoidance, §IV)
    (summarize["summary"] >> aggregate["summary"]).region("us")
    if with_exfil:
        exfil = ws.task(
            lambda eu_raw: {"out": eu_raw}, name="exfil", inputs=["eu_raw"],
            outputs=["out"], region="offshore",
        )
        (sensor["eu_raw"] >> exfil["eu_raw"]).region("offshore").fence("eu")
    return ws


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. wireframe: ghost batches expose routing, zero FLOPs moved
    ws = build_workspace()
    report = ws.ghost(
        {ws["eu_sensor"]["x"]: ShapeDtypeStruct((1024, 1024), torch.float32)}
    )
    print("ghost routing ('trust, but verify' before real data):")
    for route, info in report["routes"].items():
        print(f"  {route}: carried {info['carried']} AV(s)")

    # 2. real run + region audit from travel documents
    ws2 = build_workspace()
    fired = ws2.push("eu_sensor", x=torch.from_numpy(np.random.RandomState(0).randn(1024, 1024)).to(dev))
    report_av = fired["hq_aggregate"].av("report")
    lineage = ws2.lineage(report_av)
    audit = []

    def walk(node, depth=0):
        av = ws2.registry.get_av(node["uid"])
        crossings = av.crossed_regions()
        audit.append((depth, node["source_task"], crossings))
        print(
            f"  {'  '*depth}{node['source_task']:<14s} {node['uid']}"
            + (f"  crossed: {crossings}" if crossings else "")
        )
        for p in node["parents"]:
            walk(p, depth + 1)

    print("\nregion audit of the HQ report's lineage:")
    walk(lineage)

    # 3. fencing: a wire that refuses EU payloads
    ws3 = build_workspace(with_exfil=True)
    fence = None
    try:
        ws3.push("eu_sensor", x=torch.ones((4, 4), dtype=torch.float64, device=dev))
    except RegionFenceError as e:
        fence = str(e)
        print(f"\nfenced wire refused the transfer:\n  {e}")
    return {"routes": {r: info["carried"] for r, info in report["routes"].items()}, "audit": audit,
            "fence": fence}


if __name__ == "__main__":
    main()
