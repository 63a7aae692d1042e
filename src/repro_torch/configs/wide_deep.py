"""wide-deep [arXiv:1606.07792; paper] — 40 sparse fields, embed 32,
MLP 1024-512-256, concat interaction."""

from repro_torch.configs import registry as R
from repro_torch.models.recsys.wide_deep import WideDeepConfig

CONFIG = WideDeepConfig(
    name="wide-deep",
    n_sparse=40,
    vocab_per_field=1_000_000,   # criteo-scale rows per field
    embed_dim=32,
    n_dense=13,
    mlp=(1024, 512, 256),
    wide_vocab=4_000_000,
    n_wide_crosses=16,
)

ARCH = R.ArchSpec(
    arch_id="wide-deep",
    family="recsys",
    config=CONFIG,
    shapes=R.recsys_shapes(),
    source="arXiv:1606.07792",
    notes="retrieval shape scores one query against 1M candidates via "
          "matvec+topk",
)


def smoke_config() -> WideDeepConfig:
    return WideDeepConfig(
        name="wide-deep-smoke", n_sparse=6, vocab_per_field=100,
        embed_dim=8, n_dense=4, mlp=(32, 16), wide_vocab=200,
        n_wide_crosses=4)
