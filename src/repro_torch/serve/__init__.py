"""Paged KV cache, slot scheduler and the continuous-batching engine."""
