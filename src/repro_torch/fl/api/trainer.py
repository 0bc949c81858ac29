"""``FederatedTrainer``: the entry point over the engine (port of
``repro/fl/api/trainer.py``).

    trainer = FederatedTrainer(bundle, fl, data, RunOptions(...))
    trainer.fit(rounds)              # engine-backed, checkpoint-resumable
    trainer.evaluate()               # masked eval of the trained model
    trainer.newclient_probe(client, epochs=6)   # paper Fig. 6

With ``options.checkpoint.dir`` set, ``fit`` resumes from the last
checkpoint, so an interrupted ``fit(N)`` called again finishes the same
run.  The trainer keeps the last result for ``evaluate`` and for the
fig. 6 new-client probe (``newclient_probe``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Union

from repro_torch.fl.api.algorithm import Algorithm, make_algorithm

__all__ = ["EvalOptions", "CheckpointOptions", "EngineOptions",
           "RunOptions", "FederatedTrainer"]


@dataclass(frozen=True)
class EvalOptions:
    """Global-model evaluation cadence (the paper's per-round curves)."""

    every: int = 1            # rounds between evals (folded into the chunk at 1)
    examples: int = 2048      # pad-and-mask bucket cap


@dataclass(frozen=True)
class CheckpointOptions:
    """Server-state persistence; ``dir=None`` disables checkpointing."""

    dir: Optional[str] = None
    every: int = 10           # rounds between saves
    # the directory holds a JAX package checkpoint (converted on resume)
    from_jax: bool = False


@dataclass(frozen=True)
class EngineOptions:
    """Execution knobs of ``repro_torch.engine`` (throughput only: results
    do not depend on them).  ``telemetry`` (True, tap names, or a
    ``repro_torch.obs.Telemetry``) adds ``tele/...`` values to the history
    without changing the model; ``runlog`` (a path or a
    ``repro_torch.obs.RunLog``) records the host's spans and events;
    ``profile_dir`` writes a ``torch.profiler`` trace of the run there;
    ``halt_on_nonfinite`` stops at the first chunk boundary after a
    non-finite metric.  ``mesh`` (a ``torch.distributed`` ``DeviceMesh``,
    ``repro_torch.launch.mesh.make_engine_mesh``) runs the client-sharded
    engine, one process a rank; a mesh whose client axes multiply to 1
    runs the single-device program.  ``fused_collective`` (mesh only): one
    all-reduce a round, False the unfused oracle; ``sharded_eval`` (mesh
    only): split the eval batch over the ranks, False evaluates it whole
    on every rank."""

    superstep_rounds: Union[int, str] = 8   # rounds per chunk | "auto"
    prefetch: bool = True                   # background host staging
    # compressed runs: the EF backing — "device" dense [N, n] table,
    # "host" cohort-paged store (O(C·n) device memory, bitwise-equal),
    # "auto" pages once the dense table would pass 1 GiB
    ef_store: str = "auto"
    mesh: Any = None
    fused_collective: bool = True
    sharded_eval: bool = True
    telemetry: Any = False
    runlog: Any = None
    profile_dir: Optional[str] = None
    halt_on_nonfinite: bool = False


@dataclass(frozen=True)
class RunOptions:
    """Everything a federated run needs beyond (bundle, fl, data, rounds).
    ``device``: where the run trains (None: the card)."""

    mode: str = "client_parallel"
    seed: int = 0
    verbose: bool = False
    device: Any = None
    eval: EvalOptions = field(default_factory=EvalOptions)
    checkpoint: CheckpointOptions = field(default_factory=CheckpointOptions)
    engine: EngineOptions = field(default_factory=EngineOptions)


class FederatedTrainer:
    """Facade owning one (bundle, fl, data, options) federated workload."""

    def __init__(self, bundle, fl, data, options: Optional[RunOptions] = None):
        self.bundle = bundle
        self.fl = fl
        self.data = data
        self.options = options if options is not None else RunOptions()
        self.algorithm: Algorithm = make_algorithm(fl.algorithm)
        self._result = None

    @property
    def result(self):
        """The last ``fit`` result (``ServerResult``), or None."""
        return self._result

    @property
    def global_state(self) -> Dict[str, Any]:
        if self._result is None:
            raise RuntimeError("no trained state yet: call fit() first "
                               "(or pass global_state= explicitly)")
        return self._result.global_state

    def fit(self, rounds: int, *, callback: Optional[Callable] = None,
            global_state=None, noise_fn: Optional[Callable] = None):
        """Train to ``rounds`` total rounds through the engine (resuming
        from ``options.checkpoint.dir`` when it holds a checkpoint).
        ``global_state`` replaces the seeded initial state; ``noise_fn``
        supplies the quant codecs' offsets.  Returns the ``ServerResult``
        (also kept on the trainer)."""
        from repro_torch.engine import run_federated_engine
        o = self.options
        self._result = run_federated_engine(
            self.bundle, self.fl, self.data, rounds=rounds, seed=o.seed,
            mode=o.mode, eval_every=o.eval.every,
            eval_examples=o.eval.examples, verbose=o.verbose,
            checkpoint_dir=o.checkpoint.dir,
            checkpoint_every=o.checkpoint.every,
            checkpoint_from_jax=o.checkpoint.from_jax, callback=callback,
            superstep_rounds=o.engine.superstep_rounds,
            prefetch=o.engine.prefetch, ef_store=o.engine.ef_store,
            mesh=o.engine.mesh, fused_collective=o.engine.fused_collective,
            sharded_eval=o.engine.sharded_eval,
            telemetry=o.engine.telemetry, runlog=o.engine.runlog,
            halt_on_nonfinite=o.engine.halt_on_nonfinite,
            profile_dir=o.engine.profile_dir, global_state=global_state,
            noise_fn=noise_fn, device=o.device)
        return self._result

    def evaluate(self, global_state=None, batch=None,
                 max_examples: Optional[int] = None) -> Dict[str, float]:
        """Masked test metrics of the (last-trained) global model."""
        from repro_torch.fl.server import evaluate
        state = global_state if global_state is not None else self.global_state
        if batch is None:
            batch = self.data.test_batch()
        return evaluate(self.bundle, self.fl, state, batch,
                        max_examples if max_examples is not None
                        else self.options.eval.examples)

    def newclient_probe(self, client_data, *, epochs: int,
                        batch: Optional[int] = None,
                        lr: Optional[float] = None, seed: int = 0,
                        global_state=None):
        """Paper Fig. 6: per-epoch local accuracy of a fresh client that
        adapts from the (last-trained) aggregated global state, on that
        state's device."""
        from repro_torch.fl.newclient import newclient_convergence
        state = global_state if global_state is not None else self.global_state
        return newclient_convergence(
            self.bundle, self.fl, state, client_data, epochs=epochs,
            batch=batch if batch is not None else self.fl.local_batch,
            lr=lr if lr is not None else self.fl.lr, seed=seed)
