"""Training of the port: losses, metrics, optimizer, trainer."""

from .losses import build_loss
from .metrics import build_metric
from .optim import OptimConfig
from .trainer import BrainTrainer, TrainerConfig

__all__ = ["BrainTrainer", "OptimConfig", "TrainerConfig", "build_loss", "build_metric"]
