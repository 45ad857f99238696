"""Distribution (port of ``repro.parallel``): the sharding rules
(``sharding.py``), the cut of full tensors into rank shards, and the
collectives and rank runner a tensor-parallel engine steps through
(``collectives.py``). The pipeline schedule (``pipeline.py``) is not
ported yet."""
from .sharding import (Columns, P, batch_pspecs, cache_pspecs,
                       check_tensor_parallel, paged_cache_pspecs,
                       param_pspecs, serving_cache_layout, serving_layout,
                       shard_tree, unshard_tree)
