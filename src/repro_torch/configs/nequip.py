"""nequip [arXiv:2101.03164; paper] — O(3)-equivariant potential.

5 interaction layers, 32 channels, l_max=2, 8 radial Bessel functions,
cutoff 5 Å (Cartesian-tensor formulation; models/gnn/nequip.py).
"""

from repro_torch.configs import registry as R
from repro_torch.models.gnn.nequip import NequIPConfig

CONFIG = NequIPConfig(
    name="nequip",
    n_layers=5,
    channels=32,
    l_max=2,
    n_rbf=8,
    cutoff=5.0,
    n_species=16,
)

ARCH = R.ArchSpec(
    arch_id="nequip",
    family="nequip",
    config=CONFIG,
    shapes=R.gnn_shapes(),
    source="arXiv:2101.03164",
    notes="equivariance in Cartesian tensor basis (l<=2); positions for "
          "the non-molecular shapes are synthetic 3D embeddings",
)


def smoke_config() -> NequIPConfig:
    return NequIPConfig(name="nequip-smoke", n_layers=2, channels=8,
                        n_rbf=4, cutoff=5.0, n_species=4)
