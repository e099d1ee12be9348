"""Data parallelism, ZeRO and tensor parallelism of the port (the
counterpart of reverb_tpu/parallel/): `mesh` (process groups, the mesh, the
sharding rules, the batch), `collectives` (the autograd-aware collectives
of the tensor-parallel layers) and `sharding` (a model and optimizer laid
out over the mesh)."""
