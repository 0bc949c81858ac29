"""Round-resumable server state on disk (port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.io import (ef_disk_layout, load_tree,
                                       restore_server_state,
                                       save_server_state, save_tree)

__all__ = ["ef_disk_layout", "load_tree", "restore_server_state",
           "save_server_state", "save_tree"]
