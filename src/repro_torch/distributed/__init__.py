"""The mesh of the port: :mod:`.sharding` (the rule table, each rank's
shard and how each leaf's gradient is completed), :mod:`.group` (one
process a rank: the serve mesh's head sharding and the training mesh's
data and model subgroups, with collectives autograd can see),
:mod:`.elastic` (the largest grid the surviving devices allow) and
straggler mitigation."""
from . import straggler
