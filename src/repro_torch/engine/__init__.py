"""The port's device-resident engine (``repro.engine``): K-round
supersteps captured as CUDA graphs on the card, a host prefetch pipeline,
deferred metrics, the cohort-paged EF store, and on a mesh the
client-sharded supersteps over ``torch.distributed``.

    run_federated_engine   — the engine behind ``repro_torch.fl.server``
    make_plain_superstep / make_compressed_superstep — K-round chunks
    make_sharded_superstep / make_sharded_eval / client_sharding — the
                             shard-aware variants, one process a rank
    HostPrefetcher / StagingPool / WritebackLane — host pipeline
    MetricsPump            — asynchronous metrics into the CommLog
    make_eval_fn / pad_eval_batch — fixed-shape evaluation
"""
from repro_torch.engine.engine import (ServerResult, chunk_schedule,
                                       run_federated_engine)
from repro_torch.engine.evaljit import make_eval_fn, pad_eval_batch
from repro_torch.engine.metrics import MetricsPump
from repro_torch.engine.pipeline import (HostPrefetcher, StagingPool,
                                         WritebackLane)
from repro_torch.engine.sharded import (client_sharding, make_sharded_eval,
                                        make_sharded_superstep)
from repro_torch.engine.superstep import (make_compressed_superstep,
                                          make_plain_superstep)

__all__ = ["ServerResult", "chunk_schedule", "run_federated_engine",
           "make_eval_fn", "pad_eval_batch", "MetricsPump",
           "HostPrefetcher", "StagingPool", "WritebackLane",
           "client_sharding", "make_sharded_eval", "make_sharded_superstep",
           "make_compressed_superstep", "make_plain_superstep"]
