"""The paper's technique: similarity, codebooks, LUTs (VQ-AMM)."""
