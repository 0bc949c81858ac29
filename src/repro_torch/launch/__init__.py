"""Launchers of the port: ``serve`` (batched prefill and greedy decode on
one card) and ``train`` (LM training), plus the client-parallel engine's
meshes (``repro_torch.launch.mesh``) and layouts
(``repro_torch.launch.sharding``).  Import the modules themselves; this
package imports nothing, so importing a launcher touches no process
group."""
