from .qtensor import QTensor

__all__ = ["QTensor"]
