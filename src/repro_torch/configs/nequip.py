"""nequip: 5 interaction layers, 32 channels, l_max=2, n_rbf=8, cutoff=5 A,
E(3)-equivariant tensor products in Cartesian form.  [arXiv:2101.03164]
(counterpart of ``repro.configs.nequip``)"""
from repro_torch.models.nequip import NequIPConfig

ARCH_ID = "nequip"
FAMILY = "gnn"


def config(d_feat_in: int = 1433) -> NequIPConfig:
    return NequIPConfig(
        name=ARCH_ID, n_layers=5, channels=32, l_max=2, n_rbf=8, cutoff=5.0,
        d_feat_in=d_feat_in,
    )


def reduced_config() -> NequIPConfig:
    return NequIPConfig(
        name=ARCH_ID + "-reduced", n_layers=2, channels=8, l_max=2, n_rbf=4,
        cutoff=5.0, d_feat_in=16,
    )
