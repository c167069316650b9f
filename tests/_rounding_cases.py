"""The ADC sizing kernel's two-significant-digit rounding as it runs on the
card (``round_2sig`` in ``src/repro_torch/kernels/csrc/adc_sizing.cu``): a
binary search in ``kernels.adc_sizing.rounding_table()``, here with
``bisect``.  The tests hold it against Python's own ``float(f"{y:.2g}")``,
and the kernel against the plain version on the card; ``rounding_cases``
are the values they share."""
import bisect
import math
import random

from repro_torch.kernels.adc_sizing import FLOOR, rounding_table


def python_round_2sig(s: float) -> float:
    """What the host sizes: ``adc_sizing.adc_full_scale``'s rounding."""
    return float(f"{max(s, FLOOR):.2g}")


def table_round_2sig(s: float) -> float:
    """The kernel's ``round_2sig``: the floor, NaN kept, then the value of
    the last bound <= y."""
    bounds, values = rounding_table()
    y = FLOOR if FLOOR > s else s
    if math.isnan(y):
        return y
    return values[bisect.bisect_right(bounds, y) - 1]


def rounding_cases(n_random: int = 100_000, seed: int = 0) -> list:
    """The values every rounding test shares: ``n_random`` seeded draws
    log-uniform over [1e-30, 1e3]; the doubles at and next to every decimal
    midpoint (d + 0.5) 10^e (d = 10 .. 99, e = -31 .. 37: 1.05e-30 ..
    9.95e38, every bound of the table; exact ties where a double holds one,
    as 0.125) and every power of ten 1e-30 .. 1e38; the double below 1e39,
    the top of the table's exact range; the floor 1e-30 and its neighbours;
    values below it."""
    rng = random.Random(seed)
    vals = [10.0 ** rng.uniform(-30.0, 3.0) for _ in range(n_random)]
    for e in range(-31, 38):
        for d in range(10, 100):
            x = float(f"{d}.5e{e}")
            vals += [math.nextafter(x, 0.0), x, math.nextafter(x, math.inf)]
    for e in range(-30, 39):
        p = float(f"1e{e}")
        vals += [math.nextafter(p, 0.0), p, math.nextafter(p, math.inf)]
    vals += [math.nextafter(1e39, 0.0), math.nextafter(FLOOR, 0.0), 0.0,
             5e-324, -1.0]
    # dyadic values with few bits, among them exact decimal ties (5.25)
    vals += [(d + 0.5) * 2.0 ** -k for d in range(10, 100) for k in range(8)]
    return vals
