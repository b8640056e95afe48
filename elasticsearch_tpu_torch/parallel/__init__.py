from elasticsearch_tpu_torch.parallel.mesh import make_mesh
from elasticsearch_tpu_torch.parallel.distributed import (
    DistributedBM25, distributed_bm25_step)

__all__ = ["make_mesh", "DistributedBM25", "distributed_bm25_step"]
