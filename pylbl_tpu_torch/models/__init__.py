from .tips import TotalPartitionFunction  # noqa: F401
