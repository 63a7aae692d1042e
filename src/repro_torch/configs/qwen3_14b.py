"""qwen3-14b [hf:Qwen/Qwen3-8B family; hf] — dense, qk_norm + GQA.

40L, d_model=5120, 40 q-heads (GQA kv=8), d_ff=17408, vocab=151936.
"""

import torch

from repro_torch.configs import registry as R
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="qwen3-14b",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
    dtype=torch.bfloat16,
    param_dtype=torch.float32,
    attn_chunk=2048,
    remat="full",
)

ARCH = R.ArchSpec(
    arch_id="qwen3-14b",
    family="lm",
    config=CONFIG,
    shapes=R.lm_shapes(microbatches_train=4),
    source="hf:Qwen/Qwen3-8B",
    notes="qk_norm on per-head dims; large vocab (152k) -> vocab-sharded "
          "logits dominate the LM head",
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="qwen3-14b-smoke", n_layers=2, d_model=96, n_heads=4,
        n_kv_heads=2, head_dim=24, d_ff=192, vocab=509, qk_norm=True,
        rope_theta=1e6, dtype=torch.float32, attn_chunk=32, remat="none")
