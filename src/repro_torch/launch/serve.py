"""Batched serving driver (prefill + decode against KV / SSM caches), PyTorch port.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
      --batch 4 --prompt-len 512 --gen 32 --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \
      --reduced --batch 2 --prompt-len 8 --gen 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-medium \
      --reduced --batch 2 --prompt-len 8 --gen 4 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve --device cpu \
      --reduced --model 2 --batch 4 --prompt-len 8 --gen 4

Under a launcher that starts several processes (``torchrun``), the ranks
join its process group and serve on ``make_host_mesh(model=--model)``,
(world / model, model) ranks named ("data", "model"), with the serve rules
(``dist.step.make_serve_fns``): every rank holds its shards of the params and
caches, takes the global prompts and its own rows of them, and gathers the
logits to pick the next tokens; rank 0 prints. Without one, it runs on one
device.

Weights are random, drawn from ``--seed``; prompts from ``--seed + 1``; an
encoder-decoder's stub frames (B, frontend_len, d) from ``--seed + 2`` and a
vision model's stub prefix (B, frontend_len, d) from ``--seed + 3``, each
from a ``torch.Generator`` (the reference draws them from keys 2 and 3). The
caches hold the prefix, the prompt and the generated tokens.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.dist.step import gather_full, is_mesh, make_serve_fns, mesh_device, place_serve_params
from repro_torch.launch.mesh import join_process_group, make_host_mesh
from repro_torch.models.common import ArchConfig
from repro_torch.models.registry import build_model, init_serve_state


def make_prompts(vocab: int, batch: int, prompt_len: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(0, vocab, (batch, prompt_len), generator=gen, device=device)


def make_frontend(cfg: ArchConfig, batch: int, seed: int, device):
    """(frames, prefix): the stub frontend inputs ``cfg`` takes, each (batch,
    frontend_len, d_model) f32 normals, or None."""
    def normal(s):
        gen = torch.Generator(device=device)
        gen.manual_seed(s)
        return torch.randn((batch, cfg.frontend_len, cfg.d_model), generator=gen, device=device)

    frames = normal(seed + 2) if cfg.encoder_layers else None
    prefix = normal(seed + 3) if cfg.frontend == "vision" else None
    return frames, prefix


def serve_max_len(cfg: ArchConfig, prompt_len: int, gen: int) -> int:
    """Cache slots ``run`` asks for: the vision prefix, the prompt, the
    generated tokens and 8 spare."""
    return (cfg.frontend_len if cfg.frontend == "vision" else 0) + prompt_len + gen + 8


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg: ArchConfig, batch: int, prompt_len: int, gen: int, seed: int, device, model_axis: int = 1) -> torch.Tensor:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens with ``cfg`` and
    random weights from ``seed``, generating ``gen`` greedy tokens each: on
    ``device``, or in an initialised process group on ``make_host_mesh(
    model=model_axis)``. Prints the prefill time and decode tok/s (on a mesh,
    rank 0); returns (batch, gen) tokens (on a mesh, every rank the same)."""
    mesh = make_host_mesh(model_axis, device)
    dev = mesh_device(mesh) if is_mesh(mesh) else mesh
    model = build_model(cfg)
    max_len = serve_max_len(cfg, prompt_len, gen)

    params = model.init(seed, dev)
    if is_mesh(mesh):
        prefill_fn, decode_fn, _, shards = make_serve_fns(model, mesh, max_len=max_len, global_batch=batch)
        params = place_serve_params(params, shards, mesh)
        pick = lambda logits: gather_full(logits).argmax(dim=-1)[:, None]  # noqa: E731
        say = print if mesh.get_rank() == 0 else (lambda *a: None)
    else:
        prefill_fn, decode_fn = make_serve_fns(model, dev, max_len=max_len, global_batch=batch)
        pick = lambda logits: logits.argmax(dim=-1)[:, None]  # noqa: E731
        say = print
    state = init_serve_state(model, batch, max_len, mesh)
    prompts = make_prompts(cfg.vocab, batch, prompt_len, seed + 1, dev)
    frames, prefix = make_frontend(cfg, batch, seed, dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, state = prefill_fn(params, prompts, state, frames, prefix)
    tok = pick(logits)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    outs = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, state = decode_fn(params, tok, state)
        tok = pick(logits)
        outs.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    tokens = torch.cat(outs, dim=1)

    where = f" on {dict(zip(mesh.mesh_dim_names, mesh.shape))}" if is_mesh(mesh) else ""
    say(f"{cfg.name}{where}: prefill {batch}x{prompt_len}: {prefill_s:.3f}s")
    say(f"decode  {gen - 1} steps: {decode_s:.3f}s "
        f"({(gen - 1) * batch / max(decode_s, 1e-9):.1f} tok/s)")
    say("sample generations (token ids):")
    for row in tokens[: min(4, batch)]:
        say("  ", row.tolist())
    return tokens


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", type=int, default=1,
                    help="ranks on the mesh's model axis (tensor and expert parallelism) in a process group")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                    help="compute dtype (default: the config's own)")
    args = ap.parse_args(argv)

    join_process_group(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    return run(cfg, args.batch, args.prompt_len, args.gen, args.seed, args.device, args.model)


if __name__ == "__main__":
    main()
