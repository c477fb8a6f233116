"""The plain reference: a dense transformer in f32 (TF32 off), its loss and
AdamW, in plain PyTorch.  It imports neither ``jax``, ``repro`` nor
``repro_torch``, and takes nothing the program made: its weights come again
from the seed (:mod:`portbench.weights`)."""
