"""One gloo rank of ``tests/test_torch_analysis_sharded.py`` (torch and
``repro_torch`` only):

    python tests/_torch_analysis_worker.py RANK WORLD INIT_FILE OUT_DIR

Joins the group through the ``file://`` rendezvous ``INIT_FILE``, runs
every pass over the quick preset's sharded points on the CPU, then
lowers one sharded point with an all-reduce planted around the
superstep (issued with ``torch.distributed`` directly, not through the
point's ``ClientSharding``) and runs the collective passes on it.  Writes
``OUT_DIR/rank<RANK>.json``.
"""
import json
import os
import sys

import torch
import torch.distributed as dist

from repro_torch.analysis import (SuperstepSpec, default_matrix,
                                  lower_superstep, make_pass, run_analysis)


def planted_all_reduce(fn):
    def g(*args, **kw):
        dist.all_reduce(torch.zeros(1))
        return fn(*args, **kw)
    return g


def main(argv):
    rank, world, init, out_dir = (int(argv[0]), int(argv[1]), argv[2],
                                  argv[3])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        rep = run_analysis(default_matrix("quick", sharded=True),
                           device="cpu")
        low = lower_superstep(SuperstepSpec(codec="topk", sharded=True,
                                            n_rounds=1),
                              inner_wrap=planted_all_reduce, device="cpu")
        planted = [f.to_json() for name in ("collectives",
                                            "collective-bytes")
                   for f in make_pass(name).run(low)]
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"report": rep.to_json(), "planted": planted}, f)


if __name__ == "__main__":
    main(sys.argv[1:])
