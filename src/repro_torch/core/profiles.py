"""Representative Android device fleet (paper §4.1).

The paper extracts per-component currents from each manufacturer's
``power_profile.xml`` (cpu.active + cpu.cluster_power.cluster +
cpu.core_power.cluster at the big cluster's max frequency; wifi.active,
wifi.controller.rx/tx, wifi.controller.voltage) for the 210 most common
device models (~20% of participants), imputing the rest by SoC similarity.

We model that registry parametrically: a set of representative profiles
spanning the flagship→entry-level power/throughput range, each with a fleet
popularity weight and a country mix. Currents are in mA (power_profile.xml
units); phones are assumed to operate at 3.8 V (Deloitte 2015), as in the
paper. Training throughput is the *effective* CPU FLOP/s of the big cluster
on NN training workloads (PyTorch Mobile CPU path, fp32), which sets the
session compute duration the same way the paper's logger measures it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

VOLTAGE_V = 3.8  # Watt's law conversion voltage used by the paper


@dataclass(frozen=True)
class DeviceProfile:
    name: str
    soc: str
    # power_profile.xml fields (mA)
    cpu_active_ma: float          # cpu.active
    cpu_cluster_ma: float         # cpu.cluster_power.cluster (big)
    cpu_core_ma: float            # cpu.core_power.cluster @ max freq, per core
    big_cores: int
    wifi_active_ma: float         # wifi.active
    wifi_rx_ma: float             # wifi.controller.rx
    wifi_tx_ma: float             # wifi.controller.tx
    wifi_voltage_v: float         # wifi.controller.voltage
    # effective NN-training throughput of the big cluster (FLOP/s)
    train_gflops: float
    weight: float                 # fleet popularity weight

    @property
    def cpu_power_w(self) -> float:
        """FL training CPU power: big cluster at max frequency (paper §4.1:
        Perfetto traces show the task pinned to the big cluster at fmax)."""
        total_ma = (self.cpu_active_ma + self.cpu_cluster_ma
                    + self.big_cores * self.cpu_core_ma)
        return total_ma / 1000.0 * VOLTAGE_V

    @property
    def wifi_rx_power_w(self) -> float:
        return (self.wifi_active_ma + self.wifi_rx_ma) / 1000.0 * self.wifi_voltage_v

    @property
    def wifi_tx_power_w(self) -> float:
        return (self.wifi_active_ma + self.wifi_tx_ma) / 1000.0 * self.wifi_voltage_v


# Representative registry. Currents follow the shape of published
# power_profile.xml files (LineageOS / Pixel device trees); throughputs span
# flagship (~8 effective GFLOP/s) to entry-level (~0.8 GFLOP/s).
FLEET: Tuple[DeviceProfile, ...] = (
    DeviceProfile("pixel-7", "Tensor G2", 105, 320, 250, 4, 52, 110, 205, 3.85, 6.7, 0.06),
    DeviceProfile("pixel-3", "SDM845", 92, 285, 240, 4, 50, 100, 198, 3.85, 3.7, 0.05),
    DeviceProfile("galaxy-s21", "Exynos 2100", 110, 340, 265, 4, 55, 115, 210, 3.85, 5.9, 0.08),
    DeviceProfile("galaxy-a52", "SDM720G", 80, 210, 170, 2, 48, 95, 185, 3.80, 2.0, 0.13),
    DeviceProfile("redmi-note-11", "SDM680", 75, 195, 160, 4, 46, 92, 180, 3.80, 1.6, 0.15),
    DeviceProfile("galaxy-a13", "Exynos 850", 70, 165, 140, 4, 45, 90, 175, 3.80, 1.0, 0.14),
    DeviceProfile("moto-g-power", "SDM662", 72, 185, 150, 4, 46, 92, 178, 3.80, 1.3, 0.12),
    DeviceProfile("oneplus-9", "SD888", 108, 330, 260, 4, 54, 112, 208, 3.85, 6.3, 0.05),
    DeviceProfile("xiaomi-poco-x3", "SD732G", 82, 215, 175, 2, 48, 96, 188, 3.80, 2.2, 0.09),
    DeviceProfile("galaxy-j7", "Exynos 7870", 65, 150, 125, 4, 44, 88, 170, 3.80, 0.75, 0.07),
    DeviceProfile("pixel-6a", "Tensor G1", 100, 310, 245, 4, 51, 108, 200, 3.85, 5.6, 0.06),
)

assert abs(sum(p.weight for p in FLEET) - 1.0) < 1e-6

# country mix of FL participants (share of sessions); the paper weights
# energy by the carbon intensity of the connecting country.
COUNTRY_MIX: Dict[str, float] = {
    "US": 0.16, "IN": 0.14, "BR": 0.09, "ID": 0.07, "MX": 0.05,
    "DE": 0.05, "GB": 0.04, "FR": 0.04, "JP": 0.04, "PH": 0.04,
    "VN": 0.04, "TR": 0.03, "TH": 0.03, "EG": 0.03, "PK": 0.03,
    "NG": 0.02, "BD": 0.02, "IT": 0.02, "ES": 0.02, "PL": 0.02,
    "CA": 0.01, "AU": 0.01, "SE": 0.005, "NO": 0.005,
}
COUNTRY_MIX["OTHER"] = 0.02
_total = sum(COUNTRY_MIX.values())
COUNTRY_MIX = {k: v / _total for k, v in COUNTRY_MIX.items()}

# client uplink/downlink Wi-Fi goodput (bit/s) — residential broadband-ish
DOWNLOAD_BPS = 24e6
UPLOAD_BPS = 8e6
