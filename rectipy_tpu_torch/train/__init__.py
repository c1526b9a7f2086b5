"""Training utilities: loss functions and optimizers."""

from .losses import get_loss_function
from .optimizers import get_optimizer

__all__ = ["get_loss_function", "get_optimizer"]
