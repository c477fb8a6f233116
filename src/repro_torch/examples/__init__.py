"""Runnable demonstrations of the VPE on the port, the counterparts of the
top-level ``examples/quickstart.py`` and ``examples/image_pipeline.py``:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.image_pipeline [--device cpu]
"""
