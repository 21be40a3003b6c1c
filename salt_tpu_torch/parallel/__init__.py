"""Data and fold parallelism (``parallel/mesh.py``,
``parallel/fold_parallel.py``) and the multi-process dry run
(``parallel/dryrun.py``)."""
from salt_tpu_torch.parallel.mesh import (Mesh, init_process_group,
                                          make_mesh, pad_to_multiple,
                                          shard_batch)
