"""Paper fig. 6 on the PyTorch port: twin pipelines. A training workspace
publishes model-state artifacts; a serving workspace consults the latest
published model through an implicit client-server link. The two circuits run
on unrelated timescales.

The twin pipelines of ``examples/twin_pipelines.py`` on ``repro_torch``: the
"model" is a real (reduced) stablelm, its weights from the port's seed-0
init, trained for a few steps on the device (``registry.train_loss``,
``torch.autograd.grad``, ``optim.adamw_update`` at ``constant_lr(1e-3)``:
flash_attention and its backward on the card); the serving workspace
classifies token streams with greedy decoding (``registry.greedy_generate``:
flash_attention's prefill and flash_decode) against whichever model version
is newest. Both circuits are declared on the typed Workspace breadboard and
wired with ports.

  PYTHONPATH=src python examples/torch_twin_pipelines.py                 # on the card
  PYTHONPATH=src python examples/torch_twin_pipelines.py --device cpu
"""

import argparse
import itertools

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.models.common import resolve_device
from repro_torch.models.registry import build_model, greedy_generate, train_loss
from repro_torch.optim import adamw_init, adamw_update, constant_lr
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.workspace import Workspace, service


def run(device="cuda", params=None) -> dict:
    """The twin pipelines on ``device``; ``params``: the initial weights
    (default: the port's seed-0 init). Returns each step's loss, each served
    label and the number of frozen service responses."""
    dev = resolve_device(device)
    cfg = get_config("stablelm-1.6b").reduced()
    model = build_model(cfg)

    # ---------------- upper workspace: train --------------------------------
    params = model.init(0, dev) if params is None else params
    opt = adamw_init(params)
    published = {}  # the model registry the serving side consults
    lr = constant_lr(1e-3)

    def step(batch):
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        loss, _ = train_loss(model, params, batch)
        grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        with torch.no_grad():
            for p in leaves:
                p.requires_grad_(False)
            adamw_update(params, tree_map(lambda _: next(it), params), opt, lr(opt["count"]))
        return loss.detach()

    losses = []

    def train_task(batch):
        loss = step({k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        version = int(opt["count"])
        # the published version is a copy: the next step updates params in place
        published["latest"] = (version, tree_map(lambda t: t.clone(), params))
        losses.append(float(loss))
        return {"model_ref": {"version": version, "loss": float(loss)}}

    tick = itertools.count()
    trainer = Workspace("train")
    sample = trainer.source(
        lambda: {"batch": synthetic_batch(cfg, 4, 32, step=next(tick))},
        name="sample",
        outputs=["batch"],
    )
    train = trainer.task(train_task, name="train", inputs=["batch"], outputs=["model_ref"])
    sample["batch"] >> train["batch"]

    # ---------------- lower workspace: serve --------------------------------
    def model_lookup():  # the implicit client-server edge of fig. 6
        return published["latest"]

    def recognize(request, model_service):
        version, p = model_service()
        toks = greedy_generate(model, p, torch.as_tensor(request, dtype=torch.int32, device=dev), n_steps=4,
                               max_len=64)
        return {"label": {"model_version": version, "tokens": toks.tolist()}}

    server = Workspace("serve")
    rec = server.task(
        recognize,
        name="recognize",
        inputs=["request"],
        outputs=["label"],
        services={"model_service": service("model_lookup", model_lookup)},
    )
    server.implicit("model_lookup", rec)

    # ---------------- interleaved timescales --------------------------------
    rng = np.random.RandomState(1)
    labels = []
    for round_ in range(3):
        trainer.sample(sample)  # slow pipeline ticks
        trainer.sample(sample)
        req = rng.randint(0, cfg.vocab, size=(1, 8))
        label = server.push(rec, request=req)["recognize"]["label"]
        labels.append(label)
        print(
            f"round {round_}: served with model v{label['model_version']} "
            f"-> {label['tokens'][0]}"
        )

    # forensic traceability: the served artifact's lineage names the frozen
    # service response (which model version answered) — paper §III.D
    svc = server.pipeline.tasks["recognize"].services["model_service"]
    print(f"\nfrozen service responses: {len(svc.frozen_responses)}")
    print("last:", {k: v for k, v in svc.frozen_responses[-1].items() if k != "timestamp"})
    print("\nserve visitor log:")
    for v in server.visitor_log(rec)[-3:]:
        print(" ", v["event"], v["av_uid"], v["note"])
    return {"losses": losses, "labels": labels, "frozen": len(svc.frozen_responses)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
