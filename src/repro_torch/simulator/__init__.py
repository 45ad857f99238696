"""Cycle-approximate simulator of the LUT-DLA accelerator (port of
``repro.simulator``)."""
from .cycle_sim import (LutDlaSim, PqaSim, simulate_gemm, simulate_network,
                        BERT_BASE_LAYERS, RESNET18_LAYERS)
