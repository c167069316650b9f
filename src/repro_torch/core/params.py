"""Physical constants and device parameter sets (paper Table II).

Port of ``repro.core.params``: the same constants, the same two calibrated
presets and the same derived properties, as a plain frozen dataclass of
Python floats.  Units: SI throughout; fields are flux densities in Tesla.
The calibration provenance (RA product from the Fig. 3 energy/latency
anchors, B_E = J_AF / (Ms 6 t_f)) is documented in the reference module.

``params_from_reference`` rebuilds a ``DeviceParams`` from
``dataclasses.asdict()`` of the reference's dataclass, so both packages can
be driven from one parameter set.
"""
from __future__ import annotations

import dataclasses

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
