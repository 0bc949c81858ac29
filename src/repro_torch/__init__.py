"""PyTorch/CUDA port of the federated-learning system in ``repro``.

Mirrors ``repro``'s subpackages (``configs``, ``data``, ``models``,
``kernels``, ``core``, ``optim``, ``fl``, ``engine``) for the paper's
federated training path: FedAvg, FedMMD, FedL2 and FedFusion on the
paper's CNNs, run by ``fl.server.run_federated_reference``.  FedMMD's
Gram sum and FedFusion's conv operator are hand-written CUDA kernels for
Hopper (``csrc/``).  Imports torch and numpy only, never JAX.
"""
