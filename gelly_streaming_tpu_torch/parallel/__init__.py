"""Sharded engines over a mesh of ranks on `torch.distributed` (the JAX
package's `parallel/`): mesh.py (the mesh and its collectives),
sharded.py (the engines), multihost.py (the process group's launch, the
two-level layout), host_twin.py (their numpy twins)."""
