"""Atomic step-tagged checkpointing of the port."""
from . import checkpoint
from .checkpoint import latest_step, restore, save
