"""Training and evaluation engines (PyTorch)."""

from .tester import test
from .trainer import train

__all__ = ["test", "train"]
