"""Networking-infrastructure energy (paper §4.3): energy-per-bit model.

    P_network = (E_a + E_as + E_bng + n_e*E_e + n_c*E_c + E_ds) * B

over the path  client -> Wi-Fi AP -> edge Ethernet switch -> BNG ->
edge routers -> core routers -> edge routers -> DC Ethernet switch -> DC.
Constants follow Vishwanath et al. (2015) / Baliga et al. (2011) /
Jalali et al. (2014) per-bit energies.
"""
from __future__ import annotations

from dataclasses import dataclass

NJ = 1e-9  # nanojoule


@dataclass(frozen=True)
class NetworkEnergyModel:
    e_access_nj: float = 52.6      # Wi-Fi access point, per bit
    e_edge_switch_nj: float = 11.2  # edge Ethernet switch
    e_bng_nj: float = 30.7         # broadband network gateway
    e_edge_router_nj: float = 16.9  # per edge router
    n_edge_routers: int = 4
    e_core_router_nj: float = 2.85  # per core router
    n_core_routers: int = 8
    e_dc_switch_nj: float = 11.2   # datacenter Ethernet switch

    @property
    def energy_per_bit_j(self) -> float:
        return NJ * (self.e_access_nj + self.e_edge_switch_nj + self.e_bng_nj
                     + self.n_edge_routers * self.e_edge_router_nj
                     + self.n_core_routers * self.e_core_router_nj
                     + self.e_dc_switch_nj)

    def transfer_energy_j(self, num_bytes: float) -> float:
        return 8.0 * num_bytes * self.energy_per_bit_j


DEFAULT_NETWORK = NetworkEnergyModel()
