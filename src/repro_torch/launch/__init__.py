"""Launchers of the port: ``serve`` (batched prefill and greedy decode) and
``train`` (LM training), on one device or a mesh, with their step builders
(``steps``) and input shapes (``specs``), the meshes
(``repro_torch.launch.mesh``) and layouts (``repro_torch.launch.sharding``;
the tensor-parallel collectives are ``repro_torch.parallel``).  Import the
modules themselves; this package imports nothing, so importing a launcher
touches no process group."""
