"""The experiment lifecycle of the port: ``Experiment(**cfg).run()``."""

from .data import Data
from .experiment import Experiment
from .tracking import RunLogger, WandbLoggerConfig

__all__ = ["Data", "Experiment", "RunLogger", "WandbLoggerConfig"]
