"""Distribution (port of ``repro.parallel``): the sharding rules
(``sharding.py``), the cut of full tensors into rank shards, the
collectives and rank runner that a tensor-parallel engine and the
sharded train step step through (``collectives.py``), and the GPipe
pipeline over a ``stage`` axis (``pipeline.py``)."""
from .pipeline import pipeline, run_pipeline
from .sharding import (Columns, P, batch_pspecs, cache_pspecs,
                       check_tensor_parallel, model_shared, opt_pspecs,
                       paged_cache_pspecs, param_pspecs,
                       serving_cache_layout, serving_layout, shard_batch,
                       shard_tree, unshard_tree)
