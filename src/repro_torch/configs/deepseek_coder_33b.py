"""deepseek-coder-33b [arXiv:2401.14196; hf] — dense llama-arch.

62L, d_model=7168, 56 q-heads (GQA kv=8), d_ff=19200, vocab=32256.
"""

import torch

from repro_torch.configs import registry as R
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="deepseek-coder-33b",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab=32256,
    rope_theta=1e5,
    dtype=torch.bfloat16,
    param_dtype=torch.float32,
    attn_chunk=2048,
    remat="full",
)

ARCH = R.ArchSpec(
    arch_id="deepseek-coder-33b",
    family="lm",
    config=CONFIG,
    shapes=R.lm_shapes(microbatches_train=8),
    source="arXiv:2401.14196; hf",
    notes="dense llama-arch; fp32 master + fp32 Adam state fits at 33B",
)


def smoke_config() -> LMConfig:
    """Reduced same-family config for CPU smoke tests."""
    return LMConfig(
        name="deepseek-coder-33b-smoke", n_layers=2, d_model=128,
        n_heads=8, n_kv_heads=2, head_dim=16, d_ff=256, vocab=311,
        rope_theta=1e5, dtype=torch.float32, attn_chunk=64, remat="none")
