"""Training runtime (port of ``repro.runtime``'s one-device half): the
step watchdog and the fault-tolerant loop.  ``elastic`` and ``xla_flags``
belong to scale-out."""
from repro_torch.runtime.fault import (FaultTolerantLoop,  # noqa: F401
                                       StepWatchdog)
