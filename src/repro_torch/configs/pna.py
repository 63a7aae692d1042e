"""pna [arXiv:2004.05718; paper] — 4 layers, 75 hidden,
aggregators mean/max/min/std, scalers identity/amplification/attenuation."""

from repro_torch.configs import registry as R
from repro_torch.models.gnn.models import GNNConfig

CONFIG = GNNConfig(
    name="pna",
    arch="pna",
    n_layers=4,
    d_in=75,
    d_hidden=75,
    n_classes=10,
    aggregators=("mean", "max", "min", "std"),
    scalers=("identity", "amplification", "attenuation"),
)

ARCH = R.ArchSpec(
    arch_id="pna",
    family="gnn",
    config=CONFIG,
    shapes=R.gnn_shapes(),
    source="arXiv:2004.05718",
)


def smoke_config() -> GNNConfig:
    return GNNConfig(name="pna-smoke", arch="pna", n_layers=2, d_in=16,
                     d_hidden=12, n_classes=4)
