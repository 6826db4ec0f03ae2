"""Data, tensor and sequence parallelism over torch.distributed: the mesh
and layout (``mesh.py``) and the autograd-aware collectives
(``collectives.py``)."""
