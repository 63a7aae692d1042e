"""gat-cora [arXiv:1710.10903; paper] — 2 layers, 8 hidden, 8 heads."""

from repro_torch.configs import registry as R
from repro_torch.models.gnn.models import GNNConfig

CONFIG = GNNConfig(
    name="gat-cora",
    arch="gat",
    n_layers=2,
    d_in=1433,
    d_hidden=8,
    n_heads=8,
    n_classes=7,
)

ARCH = R.ArchSpec(
    arch_id="gat-cora",
    family="gnn",
    config=CONFIG,
    shapes=R.gnn_shapes(),
    source="arXiv:1710.10903",
)


def smoke_config() -> GNNConfig:
    return GNNConfig(name="gat-smoke", arch="gat", n_layers=2, d_in=24,
                     d_hidden=8, n_heads=4, n_classes=5)
