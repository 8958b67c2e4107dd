"""Quickstart on the PyTorch port: the KernelKMeans estimator on an OUT-OF-CORE stream.

    PYTHONPATH=src python examples/torch_stream_quickstart.py                # on the card
    PYTHONPATH=src python examples/torch_stream_quickstart.py --device cpu   # plain path, CPU

The port's counterpart of examples/stream_quickstart.py, and the same code
shape as examples/torch_quickstart.py: `backend="auto"` resolves to "stream"
for a BlockStore, so the data is clustered by exact out-of-core Lloyd with one
block at a time on the device, each block's Lloyd step (embed, assign, (Z, g,
cost)) one launch of the fused kernel `fused_apnc_step` on the card. Fit,
predict and a save/load round trip, as for a resident array.
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.api import KernelKMeans  # noqa: E402
from repro_torch.core.metrics import nmi  # noqa: E402
from repro_torch.data.synthetic import gaussian_blobs_blocks  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the plain path on the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- the input: gaussian blobs as 1024-row host blocks -------------------
    X, y_store = gaussian_blobs_blocks(3, 8000, 16, 6, block_rows=1024, separation=4.0)
    truth = y_store.materialize().ravel()
    queries = X.get(0)[:200]

    # --- identical from here on in both quickstarts --------------------------
    # no gamma given -> sigma self-tunes on the landmark sample
    est = KernelKMeans(6, kernel="rbf", l=128, m=64, n_init=4, device=dev)
    est.fit(X)
    score = nmi(est.labels_, truth)
    print(f"[fit]   backend={est.backend_} ({est.n_iter_} Lloyd iters), "
          f"inertia {est.inertia_:.1f}, NMI {score:.3f}")

    served = est.predict(queries)
    match = int((served == est.labels_[:200]).sum())
    print(f"[serve] {len(served)} online assignments, "
          f"{match}/{len(served)} match fit labels")

    with tempfile.TemporaryDirectory() as tmp:
        est.save(tmp)
        reloaded = KernelKMeans.load(tmp, device=dev)
        replay = reloaded.predict(queries)
    identical = int((replay == served).sum())
    print(f"[ckpt]  save/load round-trip: "
          f"{identical}/{len(served)} identical predictions")
    return dict(backend=est.backend_, n_iter=est.n_iter_, inertia=est.inertia_, nmi=score,
                served=len(served), served_match_fit=match, replay_identical=identical)


if __name__ == "__main__":
    main()
