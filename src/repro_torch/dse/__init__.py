"""Co-design space exploration engine (paper §VI; port of ``repro.dse``)."""
from .models import (DataflowOrder, LutDlaPoint, dataflow_memory,
                     memory_model, compute_model, parallelism_model)
from .ppa import PPA_TABLE, design_ppa, efficiency_curves, scale_to_node
from .search import SearchConstraints, co_design_search
