"""The paper's contribution on PyTorch (port of ``repro.core``).

    make_round_fn(bundle, fl_config, mode)  -> one federated round
    make_round_parts / make_compressed_round_parts -> its fused split
    ClientSharding / psum_tree / fused_psum -> the sharded aggregation
    make_compressed_round_fn(bundle, fl_config, mode, uplink, downlink)
    init_global_state(bundle, fl_config, generator, device)
    fusion_init / fusion_apply / fusion_aggregate
    mmd_loss
"""
from repro_torch.core.aggregate import ClientSharding, fused_psum, psum_tree
from repro_torch.core.fusion import (FUSION_OPS, fusion_aggregate,
                                     fusion_apply, fusion_init)
from repro_torch.core.local import make_local_loss, make_local_trainer
from repro_torch.core.losses import (accuracy, cross_entropy,
                                     masked_accuracy, masked_accuracy_sum,
                                     masked_cross_entropy,
                                     masked_cross_entropy_sum)
from repro_torch.core.mmd import mmd_loss
from repro_torch.core.rounds import (init_global_state,
                                     make_compressed_round_fn,
                                     make_compressed_round_parts,
                                     make_round_fn, make_round_parts)

__all__ = ["ClientSharding", "fused_psum", "psum_tree", "FUSION_OPS", "fusion_aggregate", "fusion_apply", "fusion_init",
           "make_local_loss", "make_local_trainer", "accuracy",
           "cross_entropy", "masked_accuracy", "masked_accuracy_sum",
           "masked_cross_entropy", "masked_cross_entropy_sum", "mmd_loss",
           "init_global_state", "make_compressed_round_fn",
           "make_compressed_round_parts", "make_round_fn",
           "make_round_parts"]
