"""Optimizer, schedules and gradient compression of the port."""
from . import adamw, compression, schedule
from .adamw import AdamWConfig
