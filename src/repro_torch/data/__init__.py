"""Data of the port: the deterministic synthetic stream and the input
pipeline (prefetch, the put onto a rank's device)."""
from . import pipeline, synthetic
from .pipeline import Prefetcher, device_put_batch
from .synthetic import DataConfig, SyntheticStream
