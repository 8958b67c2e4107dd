"""APNC clustering of LM hidden states on the PyTorch port: the paper's technique
as an analysis tool inside the training framework.

    PYTHONPATH=src python examples/torch_activation_clustering.py              # on the card
    PYTHONPATH=src python examples/torch_activation_clustering.py --smoke      # CI-sized
    PYTHONPATH=src python examples/torch_activation_clustering.py --smoke --device cpu

The port's counterpart of examples/activation_clustering.py:

1. trains a reduced qwen3 on the synthetic corpus for a few steps
   (`repro_torch.train.step`; on the card every attention forward is the
   `flash_attention_bhsd` kernel, its gradient a recompute in `torch`),
2. extracts final-norm hidden states for a batch of tokens, through the
   model's `groups` (an `nn.ModuleList`) and `transformer.apply_group_full`,
3. clusters them through the public `KernelKMeans` facade (APNC-SD: the l1
   branch of the embedding and assignment kernels on the card; the default
   rbf kernel self-tunes its bandwidth on the landmark sample),
4. reports cluster <-> token-id-bucket alignment and cluster sizes, and
   reuses the fitted estimator to assign a SECOND batch of activations.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.api import KernelKMeans  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.core.metrics import nmi  # noqa: E402
from repro_torch.data import tokens as tok_lib  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import model, transformer  # noqa: E402
from repro_torch.models.common import TEST_POLICY, rms_norm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402


def hidden_states(params, cfg, batch) -> torch.Tensor:
    """Final-norm hidden states (B, S, d): the representation we cluster."""
    with torch.no_grad():
        x = model.embed_inputs(params, cfg, TEST_POLICY, batch)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        for group in params.groups:
            x, _ = transformer.apply_group_full(group, cfg, TEST_POLICY, x, positions)
        return rms_norm(x, params.final_norm, cfg.norm_eps)


def _batch(cfg, step, batch, seq, device) -> dict:
    return {k: torch.from_numpy(v).to(device)
            for k, v in tok_lib.synthetic_batch(cfg, step, batch, seq).items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--l", type=int, default=256)
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: fewer train steps, smaller embedding")
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the plain path on the CPU")
    args = ap.parse_args(argv)
    if args.smoke:
        args.steps, args.l, args.m = 8, 64, 64
    dev = resolve_device(args.device)

    cfg = reduced(get_arch("qwen3-4b"))
    params = model.init(torch.Generator(device=dev).manual_seed(0), cfg, TEST_POLICY, dev)

    # brief training so representations carry corpus structure
    opt_cfg = AdamWConfig(lr=5e-3)
    opt_state = adamw.init(params, opt_cfg)
    ts = step_lib.make_train_step(cfg, TEST_POLICY, opt_cfg, lambda s: 1.0)
    losses = []
    for step in range(args.steps):
        params, opt_state, m = ts(params, opt_state, _batch(cfg, step, 8, 64, dev))
        losses.append(float(m["loss"]))
    print(f"[activations] trained {args.steps} steps, loss {losses[-1]:.3f}")

    # collect hidden states for fresh tokens
    batch = _batch(cfg, 999, 16, 64, dev)
    H = hidden_states(params, cfg, batch)  # (16, 64, d)
    flat = H.reshape(-1, H.shape[-1])
    tok = batch["tokens"].reshape(-1).cpu().numpy()

    # kernelized clustering of the representation space, via the facade:
    # kernel="rbf" with no gamma self-tunes sigma on the landmark sample
    k = 8
    est = KernelKMeans(k, method="sd", l=args.l, m=args.m, backend="local", device=dev)
    labels = est.fit_predict(flat, seed=1)

    # do clusters align with coarse token identity? (high-frequency zipf buckets)
    buckets = np.digitize(tok, [4, 16, 64, 256, 1024])
    score = nmi(labels, buckets)
    print(f"[activations] {flat.shape[0]} states -> {k} APNC-SD clusters "
          f"(backend={est.backend_}, {est.n_iter_} Lloyd iters)")
    print(f"[activations] NMI(cluster, token-frequency-bucket) = "
          f"{score:.3f} (>0 => representation structure found)")
    sizes = np.bincount(labels, minlength=k).tolist()
    print(f"[activations] cluster sizes: {sizes}")

    # the fitted estimator is an online assigner: new activations, no refit
    H2 = hidden_states(params, cfg, _batch(cfg, 1000, 4, 64, dev))
    labels2 = est.predict(H2.reshape(-1, H2.shape[-1]))
    sizes2 = np.bincount(labels2, minlength=k).tolist()
    print(f"[activations] assigned a fresh batch of {labels2.shape[0]} states "
          f"online: {sizes2}")
    return dict(steps=args.steps, loss_first=losses[0], loss_last=losses[-1], losses=losses,
                states=int(flat.shape[0]), backend=est.backend_, n_iter=est.n_iter_, nmi=score,
                cluster_sizes=sizes, assigned=int(labels2.shape[0]), assigned_sizes=sizes2)


if __name__ == "__main__":
    main()
