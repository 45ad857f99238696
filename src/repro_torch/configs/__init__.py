"""Architecture configurations the port serves (``config()`` is the
published configuration, ``smoke_config()`` a reduced one for CPU tests)."""
from . import qwen1p5_4b

__all__ = ["qwen1p5_4b"]
