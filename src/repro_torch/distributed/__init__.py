"""Straggler mitigation of the port (the mesh-bound modules wait for
ROADMAP queue 1, item 10)."""
from . import straggler
