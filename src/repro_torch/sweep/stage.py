"""Embed-stage persistence: resume a sweep past its dominant cost.

The first thing a sweep does, fit the embedding member and materialize Y,
is also its one expensive pass, so an interrupted sweep should not pay it
twice. `save_embed_stage` writes, crash-atomically (tmp dir, fsync of the
manifest, ``os.replace``: the checkpoint layer's discipline):

    embed_stage/
      params.npz   the fitted member's tensor fields (``params_state``)
      pool.npy     the embedded seeding pool (k-means++ reads it on resume)
      Y.bin        the cached embedding, flat row-major in the cache codec's
                   wire type (f32, the uint16 bits of bf16, or int8; read
                   back through a memmap)
      scales.npy   the (num_blocks, m) per-block, per-column dequant scales
                   (int8 only)
      stage.json   the member's config, the seeds and the run's fingerprint

The layout and the Y.bin / scales.npy bytes are the JAX package's. The
fingerprint is not: the port seeds with integers, so it records the
sweep's root seed (``sweep_seed``) and the k-means++ seed (``s_seed``)
where the JAX package records the words of its PRNG keys, and a stage
written by one package does not resume a sweep of the other.

`load_embed_stage` returns the staged pieces only when the fingerprint
(member, root seed, the input's (n, d) and the cache codec) matches the
requesting sweep, and ``Y.bin`` holds all n rows; otherwise None, and the
sweep embeds again. The seeding seed is part of the stage because it is
what makes a resumed sweep reach bit-identical candidates: the k-means++
draws replay, per restart, from the same pool.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.checkpoint import atomic_publish_dir, fsync_json
from repro_torch.stream.blockstore import BlockStore, get_codec

STAGE_DIR = "embed_stage"


def save_embed_stage(
    ckpt_dir: str | Path,
    *,
    params,
    pool: torch.Tensor,
    s_seed: int,
    y_store: BlockStore,
    sweep_seed: int,
    method: str,
    input_shape: tuple[int, int],
) -> Path:
    """Persist the embed-once artifacts under ``ckpt_dir/embed_stage/``."""
    from repro_torch.embed import embedding_for

    ckpt_dir = Path(ckpt_dir)
    codec = y_store.codec
    with atomic_publish_dir(ckpt_dir, STAGE_DIR) as tmp:
        arrays, config = embedding_for(params).params_state(params)
        np.savez(tmp / "params.npz", **arrays)
        np.save(tmp / "pool.npy", pool.detach().cpu().numpy().astype(np.float32))
        # A compressed cache persists in its wire form: Y.bin holds the codec
        # payload and scales.npy the per-block, per-column scales (int8 only;
        # bf16's scale is 1.0), so the stage keeps the compression and a
        # resume rebuilds the same quantized store, with no second rounding.
        scales = []
        with (tmp / "Y.bin").open("wb") as f:
            for i in range(y_store.num_blocks):
                enc = y_store.get_encoded(i)
                if enc is None:
                    f.write(np.ascontiguousarray(y_store.get(i), dtype=np.float32))
                else:
                    f.write(np.ascontiguousarray(enc.payload))
                    if codec == "int8":
                        scales.append(np.asarray(enc.scale, np.float32))
        if codec == "int8":
            np.save(tmp / "scales.npy", np.concatenate(scales, axis=0))
        manifest = {
            "method": method,
            "config": config,
            "s_seed": int(s_seed),
            "sweep_seed": int(sweep_seed),
            "n": int(y_store.n),
            "m": int(y_store.d),
            "block_rows": int(y_store.block_rows),
            "input_shape": [int(v) for v in input_shape],
            "cache_dtype": codec,
        }
        fsync_json(tmp / "stage.json", manifest)
    return ckpt_dir / STAGE_DIR


def load_embed_stage(
    ckpt_dir: str | Path, *, method: str, sweep_seed: int, input_shape: tuple[int, int],
    cache_dtype: str = "f32", device=None,
):
    """The staged (params, pool, s_seed, y_store), params and pool on
    ``device`` (default: the card) and Y memmapped on the host, when
    ``ckpt_dir`` holds a stage whose fingerprint matches this sweep (member,
    root seed, input (n, d), cache codec); else None (the caller embeds
    again). A stage staged under another codec is stale: clustering it would
    change the results at the codec's error scale. A Y.bin shorter than the
    n rows the manifest records is a truncated stage and is embedded again
    too."""
    from repro_torch.embed import get_embedding

    stage = Path(ckpt_dir) / STAGE_DIR
    manifest_path = stage / "stage.json"
    if not manifest_path.exists():
        return None
    manifest = json.loads(manifest_path.read_text())
    if (manifest["method"] != method
            or manifest.get("sweep_seed") != int(sweep_seed)
            or manifest.get("input_shape") != [int(v) for v in input_shape]
            or manifest.get("cache_dtype", "f32") != cache_dtype):
        return None
    codec = manifest.get("cache_dtype", "f32")
    n, m = manifest["n"], manifest["m"]
    itemsize = np.dtype(np.float32 if codec == "f32" else get_codec(codec).store_dtype).itemsize
    y_path = stage / "Y.bin"
    if not y_path.exists() or y_path.stat().st_size != n * m * itemsize:
        return None  # truncated or corrupt: embed again
    dev = resolve_device(device)
    with np.load(stage / "params.npz") as data:
        params = get_embedding(method).params_restore(
            {k: data[k] for k in data.files}, manifest["config"], device=dev)
    pool = torch.from_numpy(np.load(stage / "pool.npy")).to(dev)
    scales_path = stage / "scales.npy"
    scales = np.load(scales_path) if scales_path.exists() else None
    y_store = BlockStore.from_memmap(y_path, d=m, block_rows=manifest["block_rows"],
                                     codec=codec, scales=scales)
    return params, pool, int(manifest["s_seed"]), y_store
