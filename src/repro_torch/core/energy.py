"""Device + server energy models (paper §4.1–4.2).

Client session energy = CPU power x compute time + Wi-Fi rx power x download
time + Wi-Fi tx power x upload time (powers from power_profile.xml fields
via Watt's law at 3.8 V). Server energy = measured task power (45 W at the
conservatively assumed 1% utilization) x PUE x task duration, for each of
the two power-intensive components (Aggregator, Selector — the paper
conservatively assumes the Selector equals the Aggregator; the Coordinator
is negligible).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.carbon import PUE
from repro_torch.core.profiles import DeviceProfile

SERVER_TASK_POWER_W = 45.0    # Aggregator @1% util (paper §4.2)
N_SERVER_COMPONENTS = 2       # Aggregator + Selector (equal, conservative)


@dataclass(frozen=True)
class SessionEnergy:
    compute_j: float
    upload_j: float      # device Wi-Fi tx only (network infra separate)
    download_j: float    # device Wi-Fi rx only

    @property
    def total_j(self) -> float:
        return self.compute_j + self.upload_j + self.download_j


def client_session_energy(profile: DeviceProfile, compute_s: float,
                          download_s: float, upload_s: float) -> SessionEnergy:
    return SessionEnergy(
        compute_j=profile.cpu_power_w * compute_s,
        upload_j=profile.wifi_tx_power_w * upload_s,
        download_j=profile.wifi_rx_power_w * download_s,
    )


def server_energy_j(task_duration_s: float, *, pue: float = PUE,
                    power_w: float = SERVER_TASK_POWER_W,
                    n_components: int = N_SERVER_COMPONENTS) -> float:
    return n_components * power_w * pue * task_duration_s


def compute_duration_s(flops: float, device_gflops: float) -> float:
    return flops / (device_gflops * 1e9)


def transfer_duration_s(num_bytes: float, bps: float) -> float:
    return 8.0 * num_bytes / bps
