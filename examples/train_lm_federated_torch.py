"""End-to-end example on the PyTorch/CUDA port: federated training of a
~135M-class LM architecture, the twin of ``examples/train_lm_federated.py``.

Uses the smollm-135m config (reduced by ``--scale`` for the CPU; full
scale on the card) on a source-partitioned synthetic token stream, the LM
analogue of the paper's non-IID image splits, and runs FedAvg / FedMMD /
FedFusion rounds through ``repro_torch``'s engine (each chunk a CUDA graph
replay on the card), reporting loss and communication cost.  The flags are
the JAX example's, plus ``--device``.

Run:  PYTHONPATH=src python examples/train_lm_federated_torch.py \\
          --algorithm fedfusion --fusion-op conv --rounds 300 --scale tiny
      (add ``--device cpu`` on a machine without a card)
"""
import argparse
import dataclasses

from repro_torch.checkpoint.io import save_server_state
from repro_torch.configs import ARCH_CONFIGS
from repro_torch.configs.base import ALGORITHM_NAMES, FLConfig
from repro_torch.data import FederatedDataset, source_partition, token_stream
from repro_torch.fl.api import EvalOptions, FederatedTrainer, RunOptions
from repro_torch.models import make_bundle


def main(argv=None):
    """Parse ``argv`` (None: the command line), train, and return the
    ``ServerResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=sorted(ARCH_CONFIGS))
    ap.add_argument("--algorithm", default="fedfusion",
                    choices=sorted(ALGORITHM_NAMES))
    ap.add_argument("--fusion-op", default="conv",
                    choices=("conv", "multi", "single"))
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--scale", default="tiny", choices=("tiny", "full"),
                    help="tiny = reduced() config for CPU; full = real size")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--clients-per-round", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--local-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--save", default="",
                    help="directory to checkpoint the final server state")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = ARCH_CONFIGS[args.arch]
    if args.scale == "tiny":
        cfg = dataclasses.replace(cfg.reduced(), vocab_size=256)
    bundle = make_bundle(cfg)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"algorithm={args.algorithm}")

    toks, src = token_stream(64 * args.clients, args.seq_len,
                             vocab=cfg.vocab_size, n_sources=args.clients)
    data = FederatedDataset(source_partition(toks, src, args.clients),
                            {"tokens": toks[:64]})

    fl = FLConfig(algorithm=args.algorithm, fusion_op=args.fusion_op,
                  clients_per_round=args.clients_per_round,
                  local_steps=args.local_steps,
                  local_batch=args.local_batch, lr=args.lr, lr_decay=0.995)
    trainer = FederatedTrainer(bundle, fl, data, RunOptions(
        verbose=True, device=args.device,
        eval=EvalOptions(every=args.eval_every, examples=64)))
    res = trainer.fit(args.rounds)
    print(f"\nuploaded {res.comm.bytes_up/1e6:.1f} MB over "
          f"{res.comm.rounds} rounds  "
          f"final eval: {trainer.evaluate()}")
    if args.save:
        save_server_state(args.save, res.global_state, res.comm.rounds,
                          extra={"algorithm": args.algorithm})
        print(f"saved server state to {args.save}")
    return res


if __name__ == "__main__":
    main()
