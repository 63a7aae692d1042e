"""internlm2-20b [arXiv:2403.17297; hf] — dense GQA.

48L, d_model=6144, 48 q-heads (GQA kv=8), d_ff=16384, vocab=92544.
"""

import torch

from repro_torch.configs import registry as R
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="internlm2-20b",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92544,
    rope_theta=1e6,
    dtype=torch.bfloat16,
    param_dtype=torch.float32,
    attn_chunk=2048,
    remat="full",
)

ARCH = R.ArchSpec(
    arch_id="internlm2-20b",
    family="lm",
    config=CONFIG,
    shapes=R.lm_shapes(microbatches_train=8),
    source="arXiv:2403.17297; hf",
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="internlm2-20b-smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, head_dim=16, d_ff=192, vocab=409,
        dtype=torch.float32, attn_chunk=32, remat="none")
