"""End-to-end LM training driver on the PyTorch port: a ~10M-param llama-family
model for a few hundred steps, with checkpointing and fault tolerance active.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--d-model 256] \
        [--layers 4] [--batch 8] [--seq 256]                          # on the card
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 8 --seq 32

The port's counterpart of examples/train_lm.py: `repro_torch.launch.train`
(`TrainLoop` over the synthetic corpus, AdamW with warmup + cosine, async
checkpoints every 50 steps, resume from the latest one under `--ckpt`). On
the card every attention forward is the `flash_attention_bhsd` kernel.
A rerun with the same `--ckpt` resumes where the last one stopped.
"""
import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import train as train_cli  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the plain path on the CPU")
    args = ap.parse_args(argv)

    t0 = time.time()
    history = train_cli.main([
        "--arch", "llama3-8b",
        "--steps", str(args.steps),
        "--batch", str(args.batch),
        "--seq", str(args.seq),
        "--width", str(args.d_model),
        "--layers", str(args.layers),
        "--ckpt", args.ckpt,
        "--ckpt-every", "50",
        "--lr", "3e-3",
        *([] if args.device is None else ["--device", args.device]),
    ])
    dt = time.time() - t0
    tok_s = args.steps * args.batch * args.seq / dt
    print(f"[train_lm] {args.steps} steps in {dt:.0f}s ({tok_s:,.0f} tok/s); "
          f"loss {history[0]['loss']:.3f} -> {history[-1]['loss']:.3f}; "
          f"checkpoints + metrics under {args.ckpt}")
    return dict(steps=args.steps, seconds=dt, tokens_per_s=tok_s,
                loss_first=history[0]["loss"], loss_last=history[-1]["loss"],
                last_step=history[-1]["step"], ckpt=args.ckpt)


if __name__ == "__main__":
    main()
