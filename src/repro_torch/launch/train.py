"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 50 \\
        --batch 8 --seq 256 --ckpt run1                  # reduced arch, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --full --arch qwen1.5-0.5b
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --data-axis 2 --model-axis 2 --device cpu      # a (2, 2) mesh of CPU shards

Runs the training loop (synthetic corpus, AdamW with warmup + cosine,
async checkpoints, resume from the latest one) with the train step and
checkpoints of ``repro_torch.train``. ``--reduced`` (the default) shrinks
the arch and turns remat off, as the reference's host-scale runs do;
``--full`` keeps the arch's width and its remat. ``--data-axis`` or
``--model-axis`` above 1 run it on a (data, model) device mesh, the params
and optimizer state placed by ``distributed.sharding``'s rules: over the
visible cards (``make_mesh``, which raises when there are too few), or, with
``--device`` given, over logical shards of that one device
(``make_host_mesh``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.data import tokens
from repro_torch.device import resolve_device
from repro_torch.distributed import parallel
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import model as model_lib
from repro_torch.models.common import Policy
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train import step as step_lib
from repro_torch.train.loop import LoopConfig, TrainLoop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--width", type=int, default=0, help="override d_model (reduced)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the plain path on the CPU")
    args = ap.parse_args(argv)

    mesh = None
    if args.data_axis > 1 or args.model_axis > 1:
        shape = (args.data_axis, args.model_axis)
        mesh = (make_mesh(shape, ("data", "model")) if args.device is None
                else make_host_mesh(*shape, resolve_device(args.device)))
    device = mesh.devices.flat[0] if mesh is not None else resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        over = {}
        if args.width:
            over["d_model"] = args.width
        if args.layers:
            over["num_layers"] = args.layers
        cfg = dataclasses.replace(reduced(cfg, **over), remat="none")  # fits without remat

    policy = Policy()  # f32
    opt_cfg = AdamWConfig(lr=args.lr, moments_dtype=cfg.moments_dtype)
    params = model_lib.init(torch.Generator(device=device).manual_seed(0), cfg, policy, device)
    opt_state = adamw.init(params, opt_cfg)
    if mesh is not None:
        params = parallel.shard_model(mesh, params)
        opt_state = parallel.shard_opt_state(params, opt_state)

    def schedule(s):
        return warmup_cosine(s, warmup=max(2, args.steps // 10), total=args.steps)

    train_step = step_lib.make_train_step(cfg, policy, opt_cfg, schedule, args.accum)

    def data_factory(start_step):
        return tokens.batch_iterator(cfg, args.batch, args.seq, start_step, device)

    loop = TrainLoop(
        train_step, data_factory, args.ckpt,
        LoopConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every,
                   log_every=max(1, args.steps // 20)),
    )
    params, opt_state, history = loop.run(params, opt_state)
    first, last = history[0], history[-1]
    where = f" on a {args.data_axis} x {args.model_axis} mesh" if mesh is not None else ""
    print(f"[train] {cfg.name}{where}: step {first['step']} loss {first['loss']:.4f} -> "
          f"step {last['step']} loss {last['loss']:.4f}")
    if loop.straggler_events:
        print(f"[train] straggler events: {len(loop.straggler_events)}")
    return history


if __name__ == "__main__":
    main()
