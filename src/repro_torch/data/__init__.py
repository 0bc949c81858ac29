"""Synthetic images and token streams, client partitions and the
federated loader (numpy copies of ``repro.data`` with the same rng
streams)."""
from repro_torch.data.federated import (ChaosConfig, ChaosDraws,
                                        FederatedDataset)
from repro_torch.data.partition import (artificial_noniid_partition,
                                        class_split_partition, iid_partition,
                                        permuted_partition,
                                        source_partition)
from repro_torch.data.synth import class_images, token_stream

__all__ = ["ChaosConfig", "ChaosDraws", "FederatedDataset", "artificial_noniid_partition",
           "class_split_partition", "iid_partition", "permuted_partition",
           "source_partition", "class_images", "token_stream"]
