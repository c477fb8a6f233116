"""The plain reference: each family's model in f32 (TF32 off), its loss,
AdamW, in plain PyTorch (``<family>.py``, on the shared pieces of
``common.py``).  It imports neither ``jax``, ``repro`` nor ``repro_torch``,
and takes nothing the program made: its weights come again from the seed
(:mod:`portbench.weights`)."""
