"""Physical constants and device parameter sets (paper Table II).

Port of ``repro.core.params``: the same constants, the same two calibrated
presets and the same derived properties, as a plain frozen dataclass of
Python floats.  Units: SI throughout; fields are flux densities in Tesla.
The calibration provenance (RA product from the Fig. 3 energy/latency
anchors, B_E = J_AF / (Ms 6 t_f)) is documented in the reference module.

``params_from_reference`` rebuilds a ``DeviceParams`` from
``dataclasses.asdict()`` of the reference's dataclass, so both packages can
be driven from one parameter set.

``ProcessCorner`` / ``VariationSpec`` are the systematic process corners
and the device-to-device draws of the reference (DESIGN.md §9); the draws
come from the counter-RNG of ``kernels.noise``, whose uint32 stream is the
reference's bit for bit (its Box-Muller normals agree within a few float32
ulp, so ``lane_factors`` agree to about 2e-6 relative).  ``lane_rows``
turns them into the per-lane rows a campaign slice packs (``LaneRows``:
host-side float64 numpy, as in the reference) and ``sample_device`` into
one sampled device for the single-junction write (``DeviceSample``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

# --- physical constants (SI) -------------------------------------------------
GAMMA = 1.760859630e11     # gyromagnetic ratio [rad / (s T)]
MU0 = 1.25663706212e-6     # vacuum permeability [T m / A]
KB = 1.380649e-23          # Boltzmann [J / K]
HBAR = 1.054571817e-34     # reduced Planck [J s]
QE = 1.602176634e-19       # elementary charge [C]

EMU_PER_CC_TO_A_PER_M = 1.0e3   # 1 emu/cm^3 == 1e3 A/m


@dataclasses.dataclass(frozen=True)
class DeviceParams:
    """Compact-model parameters for one junction (AFMTJ or MTJ)."""

    # -- magnetics ------------------------------------------------------------
    ms: float            # saturation magnetization per sublattice [A/m]
    alpha: float         # Gilbert damping
    polarization: float  # spin polarization P0
    b_aniso: float       # effective uniaxial PMA field (2Ku_eff/Ms) [T]
    b_exchange: float    # inter-sublattice exchange field B_E [T]; 0 => FM/MTJ
    n_sublattices: int = 2   # 2 (AFMTJ) or 1 (MTJ)
    # -- geometry ---------------------------------------------------------
    lx: float = 45e-9
    ly: float = 45e-9
    lz: float = 0.45e-9      # free-layer thickness t_f
    # -- transport ----------------------------------------------------------
    ra_product: float = 5.97e-12   # resistance-area product [Ohm m^2]
    tmr: float = 0.8               # TMR ratio (R_AP - R_P) / R_P
    # -- spin torque ----------------------------------------------------------
    beta_flt: float = 0.05         # field-like torque ratio b_J = beta * a_J
    # -- thermal ----------------------------------------------------------
    temperature: float = 300.0     # K

    @property
    def area(self) -> float:
        return self.lx * self.ly

    @property
    def volume(self) -> float:
        return self.lx * self.ly * self.lz

    @property
    def r_parallel(self) -> float:
        return self.ra_product / self.area

    @property
    def r_antiparallel(self) -> float:
        return self.r_parallel * (1.0 + self.tmr)

    @property
    def stt_prefactor(self) -> float:
        """a_J per unit current density: a_J = pref * J  [T per A/m^2]."""
        return HBAR * self.polarization / (2.0 * QE * self.ms * self.lz)

    @property
    def thermal_stability(self) -> float:
        """Delta = E_b / kT with E_b = (1/2) B_k Ms V (per sublattice)."""
        e_b = 0.5 * self.b_aniso * self.ms * self.volume
        return e_b / (KB * self.temperature)


def params_from_reference(d: dict) -> DeviceParams:
    """``DeviceParams`` from ``dataclasses.asdict()`` of the reference's
    parameter dataclass (every field is a plain float or int there too)."""
    names = {f.name for f in dataclasses.fields(DeviceParams)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown DeviceParams fields: {sorted(unknown)}")
    kw = {k: (int(v) if k == "n_sublattices" else float(v))
          for k, v in d.items()}
    return DeviceParams(**kw)


def _afmtj_params() -> DeviceParams:
    ms = 600.0 * EMU_PER_CC_TO_A_PER_M          # Table II: Ms0 = 600 emu/cm^3
    lz = 0.45e-9
    # J_AF = 5e-3 J/m^2 normalized over the 6-plane sublattice stack (2.7 nm)
    j_af = 5e-3
    b_exchange = j_af / (ms * 6.0 * lz)
    # thermal stability target Delta ~ 40 at 300 K per sublattice pair
    volume = 45e-9 * 45e-9 * lz
    b_aniso = 2.0 * 40.0 * KB * 300.0 / (ms * volume)
    return DeviceParams(ms=ms, alpha=0.01, polarization=0.8, b_aniso=b_aniso,
                        b_exchange=b_exchange, n_sublattices=2, lz=lz)


def _mtj_params() -> DeviceParams:
    # UMN MTJ model defaults (CoFeB/MgO): Ms=1050 emu/cm^3, t_f=1.3nm, P=0.6,
    # Delta ~ 45
    ms = 1050.0 * EMU_PER_CC_TO_A_PER_M
    lz = 1.3e-9
    volume = 45e-9 * 45e-9 * lz
    b_aniso = 2.0 * 45.0 * KB * 300.0 / (ms * volume)
    return DeviceParams(ms=ms, alpha=0.01, polarization=0.6, b_aniso=b_aniso,
                        b_exchange=0.0, n_sublattices=1, lz=lz,
                        tmr=1.0)          # Table I: MTJ TMR 80-120% -> 100%


AFMTJ_PARAMS: DeviceParams = _afmtj_params()
MTJ_PARAMS: DeviceParams = _mtj_params()


# --- process corners and device-to-device variation (DESIGN.md §9) ----------
# counter-RNG draw ids, one decorrelated stream per varied parameter
_PID_ALPHA, _PID_B_ANISO, _PID_VOLUME, _PID_R = 0, 1, 2, 3
# Weyl salts folding (seed, stream) into a 32-bit stream base
_VAR_GOLD = 0x9E3779B1
_VAR_STREAM = 0xC2B2AE35


@dataclasses.dataclass(frozen=True)
class ProcessCorner:
    """One systematic process corner: multiplicative factors on the nominal
    constants plus the D2D sigmas of the within-array spread around it
    (conventions as in the reference: ``r_factor`` scales R_P and R_AP
    together; the resistance draw preserves the mean conductance)."""

    name: str = "tt"
    alpha_factor: float = 1.0
    b_aniso_factor: float = 1.0
    volume_factor: float = 1.0
    r_factor: float = 1.0
    sigma_alpha: float = 0.0
    sigma_b_aniso: float = 0.0
    sigma_volume: float = 0.0
    sigma_r: float = 0.0

    @property
    def is_nominal(self) -> bool:
        return (self.alpha_factor == self.b_aniso_factor ==
                self.volume_factor == self.r_factor == 1.0 and
                self.sigma_alpha == self.sigma_b_aniso ==
                self.sigma_volume == self.sigma_r == 0.0)


CORNER_TT = ProcessCorner("tt")
CORNER_SS = ProcessCorner("ss", alpha_factor=1.15, b_aniso_factor=1.10,
                          volume_factor=0.95, r_factor=1.15)
CORNER_FF = ProcessCorner("ff", alpha_factor=0.87, b_aniso_factor=0.91,
                          volume_factor=1.05, r_factor=0.87)
PROCESS_CORNERS = {c.name: c for c in (CORNER_TT, CORNER_SS, CORNER_FF)}


@dataclasses.dataclass(frozen=True)
class LaneRows:
    """Per-lane device-parameter rows of one (corner, stream) slice
    (host-side float64 numpy)."""

    alpha: np.ndarray       # (n,) Gilbert damping
    b_aniso: np.ndarray     # (n,) anisotropy field B_k [T]
    g_scale: np.ndarray     # (n,) junction conductance factor (= 1/r_factor)
    volume: np.ndarray      # (n,) free-layer volume [m^3]
    sigma: np.ndarray       # (n,) Brown thermal-field std per step [T]
    theta0: np.ndarray      # (n,) Boltzmann tilt scale sqrt(1/(2 Delta))

    @property
    def kernel_rows(self) -> np.ndarray:
        """(3, n) float32 block of the LLG kernel's variation rows (alpha,
        B_k, g_scale; ``kernels/llg_rk4.py``)."""
        return np.stack([self.alpha, self.b_aniso,
                         self.g_scale]).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class DeviceSample:
    """One sampled device for the single-junction write: the corner- and
    D2D-adjusted ``DeviceParams`` plus the junction conductance factor and
    the volume factor (which scales Delta and sigma but not transport, as
    the campaign's variation rows do)."""

    params: DeviceParams
    g_scale: float = 1.0
    volume_factor: float = 1.0

    @property
    def thermal_stability(self) -> float:
        return self.params.thermal_stability * self.volume_factor


@dataclasses.dataclass(frozen=True)
class VariationSpec:
    """Hashable process-variation scenario: systematic corners plus D2D
    draws salted by (seed, stream, parameter) but not by corner position,
    so every corner of a spec consumes the same standard normals (common
    random numbers, as in the reference)."""

    corners: Tuple[ProcessCorner, ...] = (CORNER_TT,)
    seed: int = 0
    distribution: str = "lognormal"     # "lognormal" | "normal"

    def __post_init__(self):
        object.__setattr__(self, "corners", tuple(self.corners))
        assert self.corners, "VariationSpec needs at least one corner"
        assert self.distribution in ("lognormal", "normal"), self.distribution

    @property
    def n_corners(self) -> int:
        return len(self.corners)

    @property
    def corner_names(self) -> Tuple[str, ...]:
        return tuple(c.name for c in self.corners)

    @property
    def is_nominal(self) -> bool:
        return all(c.is_nominal for c in self.corners)

    def at_corner(self, index: int) -> "VariationSpec":
        """Single-corner view (same seed/distribution — same D2D draws)."""
        return dataclasses.replace(self, corners=(self.corners[index],))

    @classmethod
    def from_g_sigma(cls, g_sigma: float, seed: int = 0) -> "VariationSpec":
        """The spec equivalent of the legacy conductance-only lognormal
        ``AnalogConfig.g_sigma``: a nominal corner with that resistance
        sigma."""
        return cls(corners=(dataclasses.replace(CORNER_TT, name="tt/d2d",
                                                sigma_r=float(g_sigma)),),
                   seed=seed)

    def _normals(self, param_id: int, n: int, stream: int) -> np.ndarray:
        """(n,) float64 standard normals for one varied parameter — a pure
        function of (seed, stream, param_id, lane)."""
        from repro_torch.kernels import noise   # keep params import-light

        base = (int(self.seed) * _VAR_GOLD +
                (int(stream) + 1) * _VAR_STREAM) & 0xFFFFFFFF
        lanes = noise.as_uint32(noise.cell_seeds(base, n))
        z, _ = noise.normal_pair(lanes, int(param_id) & 0xFFFFFFFF)
        return z.double().numpy()

    def _factor(self, center: float, sigma: float, param_id: int, n: int,
                stream: int, mean_preserving_reciprocal: bool = False
                ) -> np.ndarray:
        """(n,) multiplicative factors ~ D2D(center, sigma)."""
        if sigma == 0.0:
            return np.full(n, float(center))
        z = self._normals(param_id, n, stream)
        if self.distribution == "normal":
            f = np.maximum(center * (1.0 + sigma * z), 0.05 * center)
            if mean_preserving_reciprocal:
                f = f * (1.0 + sigma * sigma)
            return f
        if mean_preserving_reciprocal:
            return center * np.exp(sigma * z + 0.5 * sigma * sigma)
        return center * np.exp(sigma * z - 0.5 * sigma * sigma)

    def lane_factors(self, corner: ProcessCorner, n: int, stream: int = 0
                     ) -> np.ndarray:
        """(4, n) float64 factors (alpha, b_aniso, volume, r) for ``n``
        lanes; ``stream`` decorrelates independent slices (the analog
        programmer uses 0/1 for the pos/neg array)."""
        return np.stack([
            self._factor(corner.alpha_factor, corner.sigma_alpha,
                         _PID_ALPHA, n, stream),
            self._factor(corner.b_aniso_factor, corner.sigma_b_aniso,
                         _PID_B_ANISO, n, stream),
            self._factor(corner.volume_factor, corner.sigma_volume,
                         _PID_VOLUME, n, stream),
            self._factor(corner.r_factor, corner.sigma_r, _PID_R, n, stream,
                         mean_preserving_reciprocal=True),
        ])

    def lane_rows(self, p: DeviceParams, corner: ProcessCorner, n: int,
                  dt: float, temperature: Optional[float] = None,
                  stream: int = 0) -> LaneRows:
        """Per-lane physical rows of one campaign slice: the varied device
        constants plus the Brown sigma and Boltzmann tilt scale derived
        from them (volume and damping drive sigma; volume and anisotropy
        drive Delta)."""
        t = float(p.temperature if temperature is None else temperature)
        f = self.lane_factors(corner, n, stream)
        alpha = p.alpha * f[0]
        b_aniso = p.b_aniso * f[1]
        volume = p.volume * f[2]
        g_scale = 1.0 / f[3]
        sigma = np.sqrt(2.0 * alpha * KB * t / (GAMMA * p.ms * volume * dt))
        delta = 0.5 * b_aniso * p.ms * volume / (KB * t)
        theta0 = np.sqrt(1.0 / (2.0 * np.maximum(delta, 1.0)))
        return LaneRows(alpha=alpha, b_aniso=b_aniso, g_scale=g_scale,
                        volume=volume, sigma=sigma, theta0=theta0)

    def sample_device(self, p: DeviceParams, corner_index: int = 0,
                      lane: int = 0, stream: int = 0) -> DeviceSample:
        """Lane ``lane`` of the D2D draw at corner ``corner_index`` as one
        sampled device (``core.device.simulate_write(variation=...)``); at
        the nominal corner every factor is exactly 1.0."""
        f = self.lane_factors(self.corners[corner_index], lane + 1,
                              stream)[:, lane]
        return DeviceSample(
            params=dataclasses.replace(p, alpha=float(p.alpha * f[0]),
                                       b_aniso=float(p.b_aniso * f[1])),
            g_scale=float(1.0 / f[3]),
            volume_factor=float(f[2]),
        )
