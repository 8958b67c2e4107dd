"""Serving launcher: batched prefill + greedy (or temperature) decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b --batch 4 \\
        --prompt-len 32 --gen 16                       # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu   # plain path, CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --data-axis 2 \\
        --model-axis 2                                 # a (2, 2) mesh of CPU shards

As the reference launcher, it serves ``reduced(get_arch(arch))`` from a
random init, any of the ten archs, the prompt from ``data.tokens`` (codes for
musicgen, patch embeddings ahead of the text for llava); ``generate`` runs
any config, the full-width one included (``chip_smoke.py`` serves
qwen1.5-0.5b, rwkv6-3b, musicgen-large and more at full width through it).
``--data-axis`` / ``--model-axis`` above 1 serve it on a (data, model)
device mesh through ``distributed.parallel`` (the sharded prefill and
decode; a batch smaller than the data degree decodes against a
sequence-sharded cache): over the visible cards, or with ``--device`` over
logical shards of that device.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.data import tokens as tok_lib
from repro_torch.device import resolve_device
from repro_torch.distributed import parallel
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import attention
from repro_torch.models import model as model_lib
from repro_torch.models.common import Policy
from repro_torch.train import step as step_lib


class Generation(NamedTuple):
    tokens: torch.Tensor     # (B, gen) int64, the sampled tokens; audio codes (B, K, gen)
    logits: torch.Tensor     # (gen + 1, B, V) or (gen + 1, B, K, V): prefill's last
                             # position, then each decode step
    prefill_s: float         # prefill + cache set-up, ended by a device sync
    decode_s: float          # the gen decode steps, ended by a device sync


def sample(logits: torch.Tensor, generator: torch.Generator | None,
           temperature: float) -> torch.Tensor:
    """Greedy argmax at temperature <= 0, else a draw from softmax(logits / T)
    with ``generator``, on the logits' device (its draws differ from
    ``jax.random``'s)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def grow_cache(cache, max_len: int):
    """Each attention layer's (B, S, KV, Dh) k, v copied into zeros of length
    max_len, so decode has room (the reference pads the same way). The SSM
    layers' states (Mamba's h, conv; RWKV6's S, x_tmix, x_cmix) have no
    sequence axis and stay as they are. A mesh's cache grows on every
    coordinate, then (a batch smaller than the data degree) is cut over
    its positions."""
    if isinstance(cache, parallel.MeshCache):
        return cache.map(lambda c: grow_cache(c, max_len)).seq_split()

    def grow(name, x):
        if name not in ("k", "v"):
            return x
        buf = torch.zeros((x.shape[0], max_len, *x.shape[2:]), dtype=x.dtype, device=x.device)
        buf[:, :x.shape[1]] = x
        return buf

    return [{layer: {name: grow(name, x) for name, x in c.items()} for layer, c in group.items()}
            for group in cache]


def _quantize(c: dict) -> dict:
    """An attention layer's cache as int8 codes + scales; an SSM state as it is."""
    return attention.quantize_cache(c) if "k" in c else c


def prefill(model, cfg, policy: Policy, batch: dict, max_len: int, *,
            kv_int8: bool = False) -> tuple[torch.Tensor, list[dict]]:
    """Prefill the prompt, then grow the cache to max_len and, with kv_int8,
    quantize it (int8 codes + f32 scales per token and kv head)."""
    logits, cache = step_lib.make_prefill_step(cfg, policy)(model, batch)
    cache = grow_cache(cache, max_len)
    if kv_int8:
        def quantize(cache):
            return [{layer: _quantize(c) for layer, c in group.items()} for group in cache]
        cache = cache.map(quantize) if isinstance(cache, parallel.MeshCache) else quantize(cache)
    return logits, cache


def prompt_length(cfg, batch: dict) -> int:
    """The model positions a prefill of ``batch`` fills: S of the tokens or
    codes, plus P patch embeddings ahead of the text."""
    if cfg.frontend == "audio_codes":
        return batch["codes"].shape[2]
    prefix = batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0
    return batch["tokens"].shape[1] + prefix


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(model, cfg, policy: Policy, batch: dict, gen: int, *, temperature: float = 0.0,
             kv_int8: bool = False, generator: torch.Generator | None = None) -> Generation:
    """Prefill ``batch`` (``tokens`` (B, S); ``codes`` (B, K, S) for audio;
    ``patch_embeds`` (B, P, d) ahead of the text for vision), then ``gen``
    decode steps, each feeding the token sampled from the previous logits
    (argmax when ``temperature`` is 0; audio codes always argmax, one code a
    codebook, as the reference launcher). The attention caches hold
    ``prompt_length`` + gen positions, bf16 or, with ``kv_int8``, int8."""
    audio = cfg.frontend == "audio_codes"
    first = batch["codes" if audio else "tokens"]
    device = first.device
    prompt = prompt_length(cfg, batch)
    decode = step_lib.make_decode_step(cfg, policy)
    t0 = time.perf_counter()
    logits, cache = prefill(model, cfg, policy, batch, prompt + gen, kv_int8=kv_int8)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    def pick(logits):
        return torch.argmax(logits, dim=-1) if audio else sample(logits, generator, temperature)

    steps, toks = [logits], []
    nxt = pick(logits)
    t1 = time.perf_counter()
    for i in range(gen):
        toks.append(nxt)
        step = {"codes": nxt[:, :, None]} if audio else {"tokens": nxt[:, None]}
        logits, cache = decode(model, step, cache, prompt + i)
        steps.append(logits)
        nxt = pick(logits)
    _sync(device)
    t_decode = time.perf_counter() - t1
    out = torch.stack(toks, dim=-1) if toks else first.new_zeros((*nxt.shape, 0))
    return Generation(out, torch.stack(steps), t_prefill, t_decode)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--kv-int8", action="store_true",
                    help="quantize the KV cache after prefill (half a bf16 cache's bytes)")
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the plain path on the CPU")
    args = ap.parse_args(argv)

    mesh = None
    if args.data_axis > 1 or args.model_axis > 1:
        shape = (args.data_axis, args.model_axis)
        mesh = (make_mesh(shape, ("data", "model")) if args.device is None
                else make_host_mesh(*shape, resolve_device(args.device)))
    device = mesh.devices.flat[0] if mesh is not None else resolve_device(args.device)
    cfg = reduced(get_arch(args.arch))
    policy = Policy()
    model = model_lib.init(torch.Generator(device=device).manual_seed(0), cfg, policy, device)
    if mesh is not None:
        model = parallel.shard_model(mesh, model)
    batch = tok_lib.synthetic_batch(cfg, 0, args.batch, args.prompt_len)
    batch = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items()
             if k != "loss_mask"}
    res = generate(model, cfg, policy, batch, args.gen,
                   temperature=args.temperature, kv_int8=args.kv_int8,
                   generator=torch.Generator(device=device).manual_seed(1))
    where = f"a {args.data_axis} x {args.model_axis} mesh of {device}" if mesh is not None \
        else str(device)
    print(f"[serve] {cfg.name} on {where}: prefill {args.batch}x{args.prompt_len} in "
          f"{res.prefill_s*1e3:.1f}ms; {args.gen} decode steps in {res.decode_s*1e3:.1f}ms "
          f"({args.gen*args.batch/max(res.decode_s, 1e-9):.1f} tok/s)")
    print("[serve] sample token ids:", res.tokens[:2, :10].tolist())
    return res.tokens


if __name__ == "__main__":
    main()
