"""Distribution over ``torch.distributed``: the partition rules as data
(``sharding``), the restart state machine (``fault_tolerance``) and the one
way to start a world of ranks (``world``)."""
from repro_torch.distributed.fault_tolerance import FaultTolerantCoordinator, JobState  # noqa: F401
from repro_torch.distributed import sharding  # noqa: F401
