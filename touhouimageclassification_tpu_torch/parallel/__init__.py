"""Multi-process training and serving over ``torch.distributed``
(counterpart of the JAX package's ``parallel/``): start-up (``dist``), the
(data, expert) grid of ranks (``mesh``), which rank holds which parameter
(``sharding``), and the collectives the step runs (``collectives``)."""
from .dist import initialize_distributed
from .mesh import create_mesh, process_input_view

__all__ = ["create_mesh", "initialize_distributed", "process_input_view"]
