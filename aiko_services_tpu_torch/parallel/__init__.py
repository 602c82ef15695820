"""Multi-device collectives of the port (``aiko_services_tpu/parallel``):
meshes over an explicit device list and the ring collective matmuls."""

from .mesh import Mesh, MeshSpec, make_mesh
from .collective_matmul import (allgather_matmul, matmul_reducescatter,
                                allgather_matmul_sharded,
                                matmul_reducescatter_sharded)
from .rdma_collective import (rdma_allgather_matmul,
                              rdma_matmul_reducescatter,
                              rdma_allgather_matmul_sharded,
                              rdma_matmul_reducescatter_sharded)
