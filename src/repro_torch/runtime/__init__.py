"""Training runtime (port of ``repro.runtime``): the step watchdog and the
fault-tolerant loop; ``elastic`` (re-mesh plans) and ``xla_flags``
(collective tuning profiles for a child process's environment) are
imported from their modules."""
from repro_torch.runtime.fault import (FaultTolerantLoop,  # noqa: F401
                                       StepWatchdog)
