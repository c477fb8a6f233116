"""Straggler mitigation of the port (the mesh-bound modules wait for
ROADMAP queue 1, item 5)."""
from . import straggler
