from .context import BallistaContext, BallistaDataFrame

__all__ = ["BallistaContext", "BallistaDataFrame"]
