"""gin-tu [arXiv:1810.00826; paper] — 5 layers, 64 hidden, sum agg,
learnable eps."""

from repro_torch.configs import registry as R
from repro_torch.models.gnn.models import GNNConfig

CONFIG = GNNConfig(
    name="gin-tu",
    arch="gin",
    n_layers=5,
    d_in=64,
    d_hidden=64,
    n_classes=8,
    eps_learnable=True,
)

ARCH = R.ArchSpec(
    arch_id="gin-tu",
    family="gnn",
    config=CONFIG,
    shapes=R.gnn_shapes(),
    source="arXiv:1810.00826",
)


def smoke_config() -> GNNConfig:
    return GNNConfig(name="gin-smoke", arch="gin", n_layers=2, d_in=12,
                     d_hidden=16, n_classes=4)
