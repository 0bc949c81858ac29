"""Quickstart on the PyTorch/CUDA port: federated training with the paper's
mechanisms, the twin of ``examples/quickstart.py``.

Trains the paper's MNIST CNN (width-reduced) on a synthetic non-IID split
with FedAvg, FedMMD and FedFusion through ``repro_torch``'s engine, and
prints the communication-round savings, the paper's headline metric.

Run:  PYTHONPATH=src python examples/quickstart_torch.py            # the card
      PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import dataclasses

from repro_torch.configs import CNN_MNIST, FLConfig
from repro_torch.data import (FederatedDataset, artificial_noniid_partition,
                              class_images)
from repro_torch.fl.api import FederatedTrainer, RunOptions
from repro_torch.models import make_bundle

ALGORITHMS = (("fedavg", "multi"), ("fedmmd", "multi"), ("fedfusion", "conv"))


def main(rounds=15, target=0.5, *, device=None, shape=(28, 28, 1),
         conv_channels=(8, 16), fc_units=(64,), n_per_class=40,
         n_test_per_class=10, n_clients=8, clients_per_round=4,
         local_steps=6, local_batch=16, lr=0.1, algorithms=ALGORITHMS,
         init_state=None, verbose=True):
    """Train each algorithm for ``rounds`` rounds on ``device`` (None: the
    card); returns ``{algorithm: (rounds to target, final acc, bytes up,
    trained state)}``.  ``init_state(fl)``, when given, supplies each
    run's initial global state (e.g. a converted JAX state)."""
    # 1. Model: the paper's CNN (paper section 4.1.1), narrowed.
    cfg = dataclasses.replace(CNN_MNIST, input_shape=shape,
                              conv_channels=conv_channels,
                              fc_units=fc_units, dropout=0.0)
    bundle = make_bundle(cfg)

    # 2. Data: synthetic MNIST-like images, artificial non-IID partition
    #    (each client holds ~2 classes, the paper's hardest split).
    x, y = class_images(n_per_class, n_classes=10, shape=shape, seed=0,
                        noise=0.2, template_seed=0)
    xt, yt = class_images(n_test_per_class, n_classes=10, shape=shape,
                          seed=1, noise=0.2, template_seed=0)
    clients = artificial_noniid_partition(x, y, n_clients,
                                          shards_per_client=2)
    data = FederatedDataset(clients, {"x": xt, "y": yt})

    # 3. Train each algorithm (any repro_torch.fl.api registry name works)
    #    and compare rounds-to-target.
    results = {}
    for algo, op in algorithms:
        fl = FLConfig(algorithm=algo, fusion_op=op,
                      clients_per_round=clients_per_round,
                      local_steps=local_steps, local_batch=local_batch,
                      lr=lr, mmd_lambda=0.1)
        res = FederatedTrainer(bundle, fl, data,
                               RunOptions(device=device)).fit(
            rounds, global_state=None if init_state is None
            else init_state(fl))
        hist = res.comm.history
        to_target = next((h["round"] for h in hist
                          if h.get("acc", 0) >= target), -1)
        results[algo] = (to_target, hist[-1]["acc"], res.comm.bytes_up,
                         res.global_state)
        if verbose:
            print(f"{algo:10s} rounds_to_{target:.0%}: {to_target:3d}   "
                  f"final_acc: {hist[-1]['acc']:.3f}   "
                  f"MB_uploaded: {res.comm.bytes_up / 1e6:.1f}")

    base = results.get("fedavg", (-1,))[0]
    for algo, (rt, *_) in results.items():
        if verbose and algo != "fedavg" and rt > 0 and base > 0:
            print(f"{algo}: {100 * (1 - rt / base):.0f}% fewer rounds than "
                  "FedAvg")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rounds", type=int, default=15)
    args = ap.parse_args()
    main(args.rounds, device=args.device)
