"""What AdamW's first step does to an LM at its seeded init, at several rates.

    python3 tools/first_step_probe.py --arch rwkv6-3b                  # on the card
    python3 tools/first_step_probe.py --arch jamba-1.5-large-398b --layers 2 --experts 2
    python3 tools/first_step_probe.py --arch rwkv6-3b --layers 6 --batch 1 --seq 128 --device cpu

Takes one gradient of ``forward_train`` on batch 0 of ``batch_iterator``
(f32 parameters and math, the arch's published widths, ``--layers`` of its
depth; jamba's two layers are a Mamba + dense and a Mamba + MoE, as phase
``lm_ssm_train`` of chip_smoke.py trains them), prints its norm and the
largest leaves' norms, and then for each ``--lr`` applies AdamW's first
update to every parameter, g / (|g| + eps) after the clip, plus the
decoupled decay, reads the loss of batch 1 (and of batch 0 again), and
restores the parameters. Adam's first step moves every parameter by about
the rate whatever its gradient's size, so this reads which rates a first
step can take. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import LayerSpec  # noqa: E402
from repro_torch.data.tokens import batch_iterator  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.models.common import TEST_POLICY  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


def config(arch: str, layers: int, experts: int):
    """The arch at its widths, ``layers`` deep (0: all), jamba on its
    Mamba + dense, Mamba + MoE pair, experts cut to ``experts`` (0: all)."""
    cfg = get_arch(arch)
    over = {}
    if layers:
        over["num_layers"] = layers
    if arch.startswith("jamba") and layers:
        over["pattern"] = (LayerSpec("mamba", "dense"), LayerSpec("mamba", "moe"))[:layers]
    if experts and cfg.moe is not None:
        over["moe"] = dataclasses.replace(cfg.moe, num_experts=experts)
    return dataclasses.replace(cfg, **over)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--layers", type=int, default=0, help="0: the arch's depth")
    ap.add_argument("--experts", type=int, default=0, help="0: the arch's experts")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--lr", type=float, nargs="+", default=[3e-5, 1e-5, 3e-6, 1e-6])
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the plain path on the CPU")
    args = ap.parse_args(argv)
    if args.device is None or args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(args.device)
    cfg = config(args.arch, args.layers, args.experts)
    model = lm.init(torch.Generator(device=dev).manual_seed(0), cfg, TEST_POLICY, dev)
    data = batch_iterator(cfg, args.batch, args.seq, 0, dev)
    b0, b1 = next(data), next(data)
    named = adamw.named(model)
    for p in named.values():
        p.requires_grad_(True)
    t0 = time.perf_counter()
    loss0, _ = lm.forward_train(model, cfg, TEST_POLICY, b0)
    grads = dict(zip(named, torch.autograd.grad(loss0, list(named.values()))))
    grad_s = time.perf_counter() - t0
    opt = adamw.AdamWConfig()
    gnorm = float(torch.sqrt(sum(torch.sum(g * g) for g in grads.values())))
    clip = min(1.0, opt.grad_clip / max(gnorm, 1e-12)) if opt.grad_clip else 1.0
    out = dict(arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model, batch=args.batch,
               seq=args.seq, device=str(dev), grad_s=grad_s, loss_batch0=float(loss0.detach()),
               grad_norm=gnorm, clip=clip,
               top_leaf_norms=sorted(((float(g.norm()), n) for n, g in grads.items()),
                                     reverse=True)[:8], after_first_step={})
    with torch.no_grad():
        out["loss_batch1"] = float(lm.forward_train(model, cfg, TEST_POLICY, b1)[0])
        for lr in args.lr:
            kept = {n: p.detach().clone() for n, p in named.items()}
            for n, p in named.items():
                g = grads[n] * clip
                upd = g / (g.abs() + opt.eps)
                if opt.weight_decay and not adamw._no_decay(n, p):
                    upd = upd + opt.weight_decay * p
                p.sub_(lr * upd)
            out["after_first_step"][str(lr)] = dict(
                loss_batch1=float(lm.forward_train(model, cfg, TEST_POLICY, b1)[0]),
                loss_batch0=float(lm.forward_train(model, cfg, TEST_POLICY, b0)[0]))
            for n, p in named.items():
                p.copy_(kept[n])
            del kept
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
