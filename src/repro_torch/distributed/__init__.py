"""The serve mesh's head sharding (:mod:`.sharding`: the rule table and
each rank's shard; :mod:`.group`: one process a shard) and straggler
mitigation; training on a mesh waits for ROADMAP queue 1, item 3c."""
from . import straggler
