"""The dense decoder and its building blocks."""
