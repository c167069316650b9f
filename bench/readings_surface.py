#!/usr/bin/env python3
"""``readings.py`` for the cells whose traffic runs a driver built on the
surface driver (``surface_hybrid``): ``readings.py`` plants a fault by the
traffic's driver name, and the faults such a driver takes are the surface
faults (``benchlib/faults.py``).

    python3 bench/readings_surface.py --workload <cell> --seeds 1,2,3 [--what program,control,fault:<name>]
"""
import sys

import readings
from benchlib import faults

_plant = faults.plant


def plant(kind: str, fault: str, config: dict):
    return _plant("surface", fault, config)


if __name__ == "__main__":
    faults.plant = plant
    sys.exit(readings.main())
