"""The readings that each cell's limits are set from: the program's on many
seeds, and its control's and faults' on a few, at the cell's own sizes.

  python3 portbench/control.py --workload <name> --seeds <n> ... [--control-seeds <n> ...] [--out FILE]

For each seed of ``--seeds`` it runs the program as a run of the cell does
before and after its window (``check_rounds`` rounds of fresh prompts),
frees it, and reads the cell's compared numbers against the plain
reference. For each seed of ``--control-seeds`` it also reads them for the
control, the reference computed with float8 e4m3 products
(``reference.model.Precision("fp8")``) in the program's place, for the
fault that a serving cell can have, a served token altered (one token of
each checked round replaced by the next id), and for the witness, the
reference with bf16 products in the program's place: what the
configuration's own precision does. Prints one JSON line a seed; with
``--out`` appends them there.
It needs the card, as a run does.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def serve_readings(cell, seed: int, dev, control: bool) -> dict:
    import torch

    from portbench import harness
    from portbench.reference import model as ref_model
    from portbench.weights import make_params

    drv = harness.driver("serve")
    srv = drv.Server(cell, seed, dev)
    rounds = []
    for _ in range(cell.traffic["check_rounds"]):
        r = srv.round(srv.prompts(), timed=False)
        r.pop("state")
        rounds.append(r)
    srv.free()
    if not control:
        worst, mean, dropped = drv.served_gaps(cell, seed, dev, rounds)
        return {"program": {"max_logit_gap": worst, "mean_logit_gap": mean}, "ref_dropped_slots": dropped}
    ref_model.strict_f32()
    params = make_params(cell.config, seed, dev)
    gaps = {"program": [], "control": [], "witness_bf16": [], "fault_token_altered": []}
    for r in rounds:
        logits, _ = ref_model.served_logits(cell.config, params, r["prompts"], r["tokens"], ref_model.Precision("f32"))
        picks = {"program": r["tokens"], "fault_token_altered": r["tokens"].clone()}
        picks["fault_token_altered"][0, -1] = (r["tokens"][0, -1] + 1) % cell.config["vocab_size"]
        for key, mode in (("control", "fp8"), ("witness_bf16", "bf16")):
            low, _ = ref_model.served_logits(cell.config, params, r["prompts"], r["tokens"], ref_model.Precision(mode))
            picks[key] = low.argmax(dim=-1)
            del low
        for key, toks in picks.items():
            gaps[key].append(ref_model.logit_gaps(logits, toks).flatten())
        del logits
        torch.cuda.empty_cache()
    return {k: {"max_logit_gap": float(torch.cat(v).max()), "mean_logit_gap": float(torch.cat(v).mean())}
            for k, v in gaps.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    for p in (ROOT, ROOT / "src"):
        sys.path.insert(0, str(p))
    from portbench import harness

    cell = harness.load_cell(args.workload)
    dev = harness.card(cell.chips)
    for seed in [(s, False) for s in args.seeds] + [(s, True) for s in args.control_seeds]:
        t0 = time.perf_counter()
        line = {"workload": cell.name, "seed": seed[0], **serve_readings(cell, seed[0], dev, seed[1]),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
