"""Paper Fig. 6 on the PyTorch/CUDA port: how fast does a NEW client
converge?  The twin of ``examples/newclient_generalization.py``.

Trains a federated system on the user-specific (permuted) partition with
each algorithm through ``repro_torch``'s engine, then drops in a
never-seen client (fresh permutation) and tracks its local-adaptation
curve from the aggregated global state.

Run:  PYTHONPATH=src python examples/newclient_generalization_torch.py
      PYTHONPATH=src python examples/newclient_generalization_torch.py \\
          --device cpu
"""
import argparse
import dataclasses

from repro_torch.configs import CNN_MNIST, FLConfig
from repro_torch.data import FederatedDataset, class_images, permuted_partition
from repro_torch.fl.newclient import newclient_convergence
from repro_torch.fl.server import run_federated
from repro_torch.models import make_bundle

VARIANTS = (("fedavg", "multi"), ("fedfusion", "single"),
            ("fedfusion", "multi"), ("fedfusion", "conv"))


def main(rounds=12, epochs=6, *, device=None, shape=(28, 28, 1),
         conv_channels=(8, 16), fc_units=(64,), n_per_class=40,
         n_test_per_class=10, n_clients=8, clients_per_round=4,
         local_steps=6, local_batch=16, lr=0.08, variants=VARIANTS,
         init_state=None, verbose=True):
    """Train each variant for ``rounds`` rounds on ``device`` (None: the
    card), then probe a newcomer for ``epochs`` local epochs; returns
    ``{tag: per-epoch accuracies}``.  ``init_state(fl)``, when given,
    supplies each run's initial global state."""
    cfg = dataclasses.replace(CNN_MNIST, input_shape=shape,
                              conv_channels=conv_channels,
                              fc_units=fc_units, dropout=0.0)
    bundle = make_bundle(cfg)

    x, y = class_images(n_per_class, n_classes=10, shape=shape, seed=0,
                        noise=0.2, template_seed=0)
    xt, yt = class_images(n_test_per_class, n_classes=10, shape=shape,
                          seed=1, noise=0.2, template_seed=0)

    # the newcomer has a permutation no training client ever saw
    new = permuted_partition(x, y, 1, seed=777)[0]

    if verbose:
        print(f"{'variant':18s} " + " ".join(f"ep{i+1:<6d}"
                                             for i in range(epochs)))
    curves = {}
    for algo, op in variants:
        fl = FLConfig(algorithm=algo, fusion_op=op,
                      clients_per_round=clients_per_round,
                      local_steps=local_steps, local_batch=local_batch,
                      lr=lr, lr_decay=0.99)
        data = FederatedDataset(permuted_partition(x, y, n_clients),
                                {"x": xt, "y": yt})
        res = run_federated(bundle, fl, data, rounds=rounds, device=device,
                            global_state=None if init_state is None
                            else init_state(fl))
        accs = newclient_convergence(bundle, fl, res.global_state,
                                     {"x": new["x"], "y": new["y"]},
                                     epochs=epochs, batch=local_batch, lr=lr)
        tag = op if algo == "fedfusion" else "fedavg"
        curves[tag] = accs
        if verbose:
            print(f"{tag:18s} " + " ".join(f"{a:.3f}  " for a in accs))
    return curves


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--epochs", type=int, default=6)
    args = ap.parse_args()
    main(args.rounds, args.epochs, device=args.device)
