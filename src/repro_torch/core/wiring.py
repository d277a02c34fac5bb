"""Breadboard wiring language (paper fig. 5, §III.H).

Parses descriptions like::

    [tfmodel]
    (in) learn-tf (model)
    (model) server (lookup implicit)
    (in[10/2]) convert (json)
    (json, lookup implicit) predict (result)

Each line is ``(inputs) taskname (outputs)``. Input tokens may carry buffer
``[N]`` / sliding-window ``[N/k]`` annotations; the token suffix ``implicit``
marks a client-server side channel (§III.D) rather than a pipeline wire.
A leading ``[name]`` line names the circuit. Matching output->input names are
wired automatically ('each matching promise of an output (+) is matched by the
promise to consume it (-)').
"""

from __future__ import annotations

import re
from typing import Callable, Optional

from .pipeline import Pipeline
from .policy import InputSpec
from .task import SmartTask

_LINE = re.compile(r"^\(([^)]*)\)\s*([\w.\-]+)\s*\(([^)]*)\)$")


def _split_ports(text: str) -> list:
    return [p.strip() for p in text.split(",") if p.strip()]


def parse_wiring(
    text: str,
    impls: dict,
    default_mode: str = "all_new",
    modes: Optional[dict] = None,
) -> Pipeline:
    """Deprecated entry point — use ``Workspace.from_wiring(text, impls)``
    (repro_torch.workspace), which wraps the same parser behind the typed facade."""
    from .pipeline import _deprecated

    _deprecated("parse_wiring", "Workspace.from_wiring(text, impls)")
    return build_wiring(text, impls, default_mode=default_mode, modes=modes)


def build_wiring(
    text: str,
    impls: dict,
    default_mode: str = "all_new",
    modes: Optional[dict] = None,
) -> Pipeline:
    """Build a Pipeline from a wiring description (the parsing engine).

    impls: task name -> python callable (the plugin user code).
    modes: optional per-task snapshot mode overrides.
    """
    modes = modes or {}
    name = "circuit"
    rows = []
    for raw in text.strip().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^\[(\w+)\]$", line)
        if m:
            name = m.group(1)
            continue
        m = _LINE.match(line)
        if not m:
            raise ValueError(f"unparseable wiring line: {raw!r}")
        ins, task, outs = m.groups()
        rows.append((_split_ports(ins), task, _split_ports(outs)))

    pipe = Pipeline(name)
    implicit_inputs: dict = {}
    for ins, tname, outs in rows:
        if tname not in impls:
            raise KeyError(f"no implementation supplied for task {tname!r}")
        wires, implicits = [], []
        for tok in ins:
            if tok.endswith(" implicit"):
                implicits.append(tok[: -len(" implicit")].strip())
            else:
                wires.append(tok)
        # outputs may also declare 'implicit' service exposure; keep the name.
        out_names = [o.replace(" implicit", "").strip() for o in outs]
        task = SmartTask(
            name=tname,
            fn=impls[tname],
            inputs=wires,
            outputs=out_names,
            mode=modes.get(tname, default_mode),
            source=(len(wires) == 0),
        )
        pipe._add_task(task)
        implicit_inputs[tname] = implicits

    # wire matching output names to input names across tasks
    producers: dict = {}
    for ins, tname, outs in rows:
        for o in outs:
            producers.setdefault(o.replace(" implicit", "").strip(), []).append(tname)
    for ins, tname, outs in rows:
        for tok in ins:
            if tok.endswith(" implicit"):
                continue
            port = InputSpec.parse(tok).name
            for src in producers.get(port, []):
                if src != tname:
                    pipe._connect(src, port, tname, port)
    # implicit client-server edges recorded in the design map via link-less note
    pipe.implicit_edges = [
        (svc, tname) for tname, svcs in implicit_inputs.items() for svc in svcs
    ]
    return pipe
