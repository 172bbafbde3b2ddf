"""The `Environment` bundle: every externally-given model the carbon
accounting depends on — network energy-per-bit, grid carbon intensities,
datacenter fleet + PUE, device fleet, participation country mix, and link
bandwidths — as one swappable, JSON-serializable value.

The seed codebase hard-wired all of these as module-level defaults; an
`Environment` threads them explicitly through `SessionSampler` and
`CarbonEstimator`, which is what makes scenarios like geographically
shifted intensity (CAFE) or a device-heterogeneous fleet expressible as
config rather than code forks.

Time is first-class: ``intensity_schedule`` maps countries to
piecewise-constant diurnal gCO2e/kWh curves (equal segments over a 24 h
cycle; ``intensity_phase_h`` carries per-country UTC offsets so the shared
task clock lines up with local solar time). An empty/constant schedule is
the degenerate static case and stays bit-for-bit identical to the plain
table. ``Environment.preset`` ships the named scenario bundles: the
"diurnal" grid and the device-heterogeneous "flagship-only" /
"entry-heavy" fleets.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Mapping, Optional, Sequence, Tuple

from repro_torch.configs.base import FederatedConfig, ModelConfig
from repro_torch.core.availability import AvailabilityModel
from repro_torch.core.carbon import (CARBON_INTENSITY, DATACENTER_LOCATIONS, PUE,
                               UTC_OFFSET_H, IntensityModel,
                               diurnal_schedule)
from repro_torch.core.energy import SERVER_TASK_POWER_W
from repro_torch.core.estimator import CarbonEstimator
from repro_torch.core.faults import FaultModel
from repro_torch.core.network import NetworkEnergyModel
from repro_torch.core.profiles import (COUNTRY_MIX, DOWNLOAD_BPS, FLEET, UPLOAD_BPS,
                                 DeviceProfile)
from repro_torch.federated.events import SessionSampler

_FLAGSHIP_GFLOPS = 5.0    # flagship cut line for the fleet presets
_ENTRY_GFLOPS = 2.0


@dataclass(frozen=True)
class Environment:
    network: NetworkEnergyModel = field(default_factory=NetworkEnergyModel)
    carbon_intensity: Mapping[str, float] = field(
        default_factory=lambda: dict(CARBON_INTENSITY))
    datacenter_locations: Mapping[str, int] = field(
        default_factory=lambda: dict(DATACENTER_LOCATIONS))
    pue: float = PUE
    fleet: Tuple[DeviceProfile, ...] = FLEET
    country_mix: Mapping[str, float] = field(
        default_factory=lambda: dict(COUNTRY_MIX))
    download_bps: float = DOWNLOAD_BPS
    upload_bps: float = UPLOAD_BPS
    server_power_w: float = SERVER_TASK_POWER_W
    # time-varying grid: country -> per-segment gCO2e/kWh over a 24 h
    # cycle (empty = static), country -> phase offset in hours
    intensity_schedule: Mapping[str, Sequence[float]] = field(
        default_factory=dict)
    intensity_phase_h: Mapping[str, float] = field(default_factory=dict)
    # failure process: per-country (time-varying) hazards + correlated
    # burst outages; the all-zero default is the fault-free engine
    fault: FaultModel = field(default_factory=FaultModel)
    # device availability: per-country (time-varying) eligibility curves
    # gating admission + mid-session churn; the all-available default is
    # the availability-blind engine (see repro_torch.core.availability —
    # ``diurnal_availability(countries)`` builds the canonical
    # anti-correlated evening-charging-peak model)
    availability: AvailabilityModel = field(
        default_factory=AvailabilityModel)

    def __post_init__(self):
        if self.download_bps <= 0 or self.upload_bps <= 0:
            raise ValueError(
                "Environment link bandwidths must be > 0, got "
                f"download_bps={self.download_bps!r} "
                f"upload_bps={self.upload_bps!r}")
        if self.pue < 1.0:
            raise ValueError(f"Environment.pue must be >= 1.0 "
                             f"(it multiplies IT power), got {self.pue!r}")
        if self.server_power_w < 0:
            raise ValueError("Environment.server_power_w must be >= 0, "
                             f"got {self.server_power_w!r}")
        if not self.fleet:
            raise ValueError("Environment.fleet must name at least one "
                             "device profile")
        if self.country_mix:
            bad = {c: w for c, w in self.country_mix.items() if w < 0}
            if bad:
                raise ValueError(
                    f"Environment.country_mix has negative weights: {bad}")
            if not sum(self.country_mix.values()) > 0:
                raise ValueError("Environment.country_mix weights must "
                                 "sum to > 0")

    # ------------------------------------------------------------ presets
    @classmethod
    def preset(cls, name: str, **overrides) -> "Environment":
        """Named scenario bundles (further ``Environment`` kwargs may be
        layered on top):

        * ``"diurnal"`` — every country's intensity swings through the
          default diurnal shape (midday solar dip, evening peak) around
          its static mean, phased by UTC offset. The canonical
          time-varying grid for carbon-aware scheduling experiments.
        * ``"flagship-only"`` — the device fleet restricted to flagship
          SoCs (>= ~5 effective GFLOP/s): short sessions, high power.
        * ``"entry-heavy"`` — fleet popularity reweighted toward
          entry-level devices (3x weight under ~2 GFLOP/s, flagships
          halved): long sessions on low-power silicon.
        """
        if name == "diurnal":
            base = dict(intensity_schedule=diurnal_schedule(),
                        intensity_phase_h=dict(UTC_OFFSET_H))
        elif name == "flagship-only":
            base = dict(fleet=tuple(
                p for p in FLEET if p.train_gflops >= _FLAGSHIP_GFLOPS))
        elif name == "entry-heavy":
            base = dict(fleet=tuple(
                dataclasses.replace(
                    p, weight=p.weight * (
                        3.0 if p.train_gflops < _ENTRY_GFLOPS else
                        0.5 if p.train_gflops >= _FLAGSHIP_GFLOPS else 1.0))
                for p in FLEET))
        else:
            raise ValueError(
                f"unknown Environment preset {name!r}; known: "
                "'diurnal', 'flagship-only', 'entry-heavy'")
        base.update(overrides)
        return cls(**base)

    # ------------------------------------------------------------ wiring
    def intensity_model(self) -> IntensityModel:
        return IntensityModel(table=dict(self.carbon_intensity),
                              datacenter_locations=dict(
                                  self.datacenter_locations),
                              pue=self.pue,
                              schedule={c: tuple(v) for c, v in
                                        self.intensity_schedule.items()},
                              phase_h=dict(self.intensity_phase_h))

    def estimator(self) -> CarbonEstimator:
        return CarbonEstimator(network=self.network,
                               profiles={p.name: p for p in self.fleet},
                               intensity=self.intensity_model(),
                               server_power_w=self.server_power_w)

    def sampler(self, model_cfg: ModelConfig, fed: FederatedConfig,
                seq_len: int) -> SessionSampler:
        return SessionSampler(model_cfg, fed, seq_len,
                              fleet=self.fleet,
                              country_mix=self.country_mix,
                              download_bps=self.download_bps,
                              upload_bps=self.upload_bps,
                              fault=self.fault,
                              availability=self.availability)

    # ------------------------------------------------- JSON round-tripping
    def to_dict(self) -> dict:
        out = {
            "network": dataclasses.asdict(self.network),
            "carbon_intensity": dict(self.carbon_intensity),
            "datacenter_locations": dict(self.datacenter_locations),
            "pue": self.pue,
            "fleet": [dataclasses.asdict(p) for p in self.fleet],
            "country_mix": dict(self.country_mix),
            "download_bps": self.download_bps,
            "upload_bps": self.upload_bps,
            "server_power_w": self.server_power_w,
            "intensity_schedule": {c: list(v) for c, v in
                                   self.intensity_schedule.items()},
            "intensity_phase_h": dict(self.intensity_phase_h),
        }
        fd = self.fault.to_dict()
        if fd:                      # default (fault-free) stays implicit
            out["fault"] = fd
        ad = self.availability.to_dict()
        if ad:                      # default (all-available) stays implicit
            out["availability"] = ad
        return out

    @classmethod
    def from_dict(cls, d: Optional[Mapping]) -> "Environment":
        if not d:
            return cls()
        d = dict(d)
        if isinstance(d.get("network"), Mapping):
            d["network"] = NetworkEnergyModel(**d["network"])
        if d.get("fleet") is not None:
            d["fleet"] = tuple(
                p if isinstance(p, DeviceProfile) else DeviceProfile(**p)
                for p in d["fleet"])
        if not isinstance(d.get("fault"), FaultModel):
            d["fault"] = FaultModel.from_dict(d.get("fault"))
        if not isinstance(d.get("availability"), AvailabilityModel):
            d["availability"] = AvailabilityModel.from_dict(
                d.get("availability"))
        return cls(**d)
