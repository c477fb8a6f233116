"""Straggler mitigation of the port (the mesh-bound modules wait for
ROADMAP queue 1, items 3b and 3c)."""
from . import straggler
