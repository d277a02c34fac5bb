"""Roofline model of one step of the port on H100s, from counted ops.

Port of ``repro.roofline.model``, which prices compiled HLO for the TPU v5e.
Three terms per (arch x shape x mesh) cell, in seconds, for one device:

  compute    = FLOPs / peak bf16 FLOP/s
  memory     = traffic bytes / HBM bytes/s
  collective = sum over collectives of (ring-weighted payload bytes)
               / link bytes/s

FLOPs, traffic and collectives are one rank's, as ``op_costs.OpCounter``
counts the ops it dispatches (the reference reads the per-partition HLO,
``roofline/hlo_costs.py``). The ring weights are the reference's:

  all-reduce      2 x (n-1)/n      (reduce-scatter + all-gather)
  all-gather      (n-1)/n          (each rank receives (n-1)/n of the result)
  reduce-scatter  (n-1)/n
  all-to-all      (n-1)/n
  collective-permute 1

where n is the size of the op's process group, and the payload is the
result's bytes on one rank: the gathered tensor of an all-gather, the shard
of a reduce-scatter.

``H100_SXM`` is the card the port runs on, from NVIDIA's data sheet (SXM,
dense, at the 700 W limit): 989e12 bf16 FLOP/s, 3.35e12 HBM bytes/s, 80e9
HBM bytes. ``link_bw`` is 50e9 bytes/s a direction: one 400 Gb/s NDR
InfiniBand port a GPU. A node holds 8 GPUs joined by NVLink, but every
group of the (16, 16) and (2, 16, 16) meshes crosses nodes: a group over
``data``, ``model`` or several axes has 16 ranks or more, so it spans two or
more nodes, and the ``pod`` group pairs ranks of two pods. A ring runs at
its slowest hop, which is that port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops_bf16: float  # per device
    hbm_bw: float  # bytes/s per device
    link_bw: float  # bytes/s per device and direction, between nodes
    hbm_bytes: float  # capacity per device


H100_SXM = HardwareSpec(
    name="nvidia-h100-sxm",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    link_bw=50e9,
    hbm_bytes=80e9,
)

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def ring_weight(kind: str, n: int) -> float:
    """The ring algorithm's factor on a payload, over a group of n ranks."""
    if kind == "all-reduce":
        return 2.0 * (n - 1) / max(n, 1)
    if kind == "collective-permute":
        return 1.0
    return (n - 1) / max(n, 1)


def collective_bytes(ops) -> dict:
    """Per-kind payload bytes, ring-weighted, of ``ops``: (kind, payload
    bytes on one rank, group size) each, as ``op_costs.OpCounter`` records
    them; the reference's ``collective_bytes`` reads them from HLO text.
    Also by kind and group size (``"all-reduce@n16"``: group size 2 on the
    two-pod mesh is the traffic between pods), outside the totals."""
    out = {k: {"bytes": 0, "weighted_bytes": 0.0, "count": 0} for k in COLLECTIVE_KINDS}
    for kind, payload, n in ops:
        w = ring_weight(kind, n)
        for key in (kind, f"{kind}@n{n}"):
            c = out.setdefault(key, {"bytes": 0, "weighted_bytes": 0.0, "count": 0})
            c["bytes"] += payload
            c["weighted_bytes"] += payload * w
            c["count"] += 1
    out["total_bytes"] = sum(out[k]["bytes"] for k in COLLECTIVE_KINDS)
    out["total_weighted"] = sum(out[k]["weighted_bytes"] for k in COLLECTIVE_KINDS)
    return out


def model_flops(cfg, seq_len: int, global_batch: int, kind: str) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·D (inference) plus the
    attention term 2·n_attn·B·H·(dk+dv)·Σ_context (causal ⇒ L²/2; SWA caps
    the context at the window; decode ⇒ one row of length S). Layers are
    counted over ``cfg.layer_specs()``, as the reference counts its layout
    times its groups."""
    n_active = cfg.n_active_params()
    B, L = global_batch, seq_len
    tokens = B * (1 if kind == "decode" else L)
    mult = 6.0 if kind == "train" else 2.0
    total = mult * n_active * tokens

    # attention context flops (not part of 6ND)
    n_attn = sum(1 for s in cfg.layer_specs() if s.mixer == "attention")
    if cfg.encoder_layers:
        n_attn += cfg.encoder_layers + cfg.n_layers  # enc self + dec cross
    if n_attn:
        if cfg.attention == "mla":
            H = cfg.n_heads
            dsum = cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim
        else:
            H = cfg.n_heads
            dsum = 2 * cfg.head_dim
        if kind == "decode":
            ctx = min(L, cfg.window) if (cfg.attention == "swa" and cfg.window) else L
            pair_sum = B * ctx  # one new token vs S cached
        else:
            if cfg.attention == "swa" and cfg.window and cfg.window < L:
                pair_sum = B * L * cfg.window
            else:
                pair_sum = B * L * L / 2.0  # causal
        total += (mult / 2.0) * n_attn * 2.0 * H * dsum * pair_sum
    return total


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    kind: str
    hlo_gflops: float  # per device: the counted ops' FLOPs (the reference's key)
    hlo_gbytes: float  # per device: the counted ops' traffic
    collectives: dict
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_gflops_total: float
    useful_flops_frac: float  # MODEL_FLOPS / (FLOPs * devices)
    per_device_peak_memory: Optional[float] = None
    xla_cost_analysis: Optional[dict] = None  # the reference's XLA cross-check; None here
    t_memory_raw: Optional[float] = None  # memory term before kernel credit
    kernel_credit: Optional[dict] = None
    buckets: Optional[dict] = None
    flops_split: Optional[dict] = None  # {"dot": FLOPs of matrix products, "other": the rest}
    hardware: HardwareSpec = H100_SXM
    note: str = ""

    def to_record(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def roofline_frac(self) -> float:
        """useful-FLOPs utilization at the roofline bound: MODEL_FLOPS /
        (devices * peak * max(terms)), at the peak of the spec the report
        was priced with — an MFU-at-bound estimate."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t <= 0:
            return 0.0
        return (self.model_gflops_total * 1e9) / (self.n_devices * self.hardware.peak_flops_bf16 * t)


def analyze(
    costs: dict,
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    n_devices: int,
    kind: str,
    cfg,
    seq_len: int,
    global_batch: int,
    hw: HardwareSpec = H100_SXM,
    mesh_shape: Optional[dict] = None,
    rules: Optional[dict] = None,
) -> RooflineReport:
    """The report of one rank's counted run (``op_costs.OpCounter.costs()``),
    the counterpart of the reference's ``analyze_compiled``. With
    ``mesh_shape`` and ``rules``, each kernel region's traffic is replaced by
    the kernel's IO (``kernel_credit``)."""
    flops = costs["flops"]
    bytes_accessed = costs["traffic_bytes"]
    coll = {
        **costs["collectives"],
        "total_bytes": costs["collective_bytes"],
        "total_weighted": costs["collective_weighted_bytes"],
    }

    credit = None
    if mesh_shape is not None and rules is not None:
        from .kernel_credit import apply_kernel_credit, kernel_io_bytes

        io = kernel_io_bytes(cfg, kind, seq_len, global_batch, mesh_shape, rules)
        credit = apply_kernel_credit(bytes_accessed, costs["buckets"], io)

    t_compute = flops / hw.peak_flops_bf16
    t_memory_raw = bytes_accessed / hw.hbm_bw
    t_memory = credit["corrected_traffic"] / hw.hbm_bw if credit else t_memory_raw
    t_coll = coll["total_weighted"] / hw.link_bw

    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)

    mfl = model_flops(cfg, seq_len, global_batch, kind)
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        n_devices=n_devices,
        kind=kind,
        hlo_gflops=flops / 1e9,
        hlo_gbytes=bytes_accessed / 1e9,
        collectives=coll,
        t_compute=t_compute,
        t_memory=t_memory,
        t_collective=t_coll,
        bottleneck=bottleneck,
        model_gflops_total=mfl / 1e9,
        useful_flops_frac=mfl / max(flops * n_devices, 1.0),
        per_device_peak_memory=costs.get("peak_bytes"),
        t_memory_raw=t_memory_raw,
        kernel_credit=credit,
        buckets=costs["buckets"],
        flops_split={"dot": costs["dot_flops"], "other": costs["other_flops"]},
        hardware=hw,
    )
