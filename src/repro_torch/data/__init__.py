"""Data of the port: the deterministic synthetic stream."""
from . import synthetic
from .synthetic import DataConfig, SyntheticStream
