"""arctic-480b [hf:Snowflake/snowflake-arctic-base; hf] — dense+MoE hybrid.

35L, d_model=7168, 56 q-heads (GQA kv=8), MoE 128 experts top-2 with
d_ff=4864 per expert, PLUS a dense residual FFN in parallel, vocab=32000.

Memory note: 468B params -> int8 first moment + factored second moment +
bf16 params (~3 B/param optimizer+weights) to fit a 256-chip pod.
"""

import torch

from repro_torch.configs import registry as R
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="arctic-480b",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab=32000,
    moe=True,
    n_experts=128,
    moe_topk=2,
    dense_residual=True,
    residual_d_ff=4864,
    expert_shard="expert",       # 128 experts / 16-way TP = 8 per shard
    capacity_factor=1.25,
    rope_theta=1e4,
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,    # memory: bf16 weights + int8/factored Adam
    attn_chunk=1024,
    remat="full",
)

ARCH = R.ArchSpec(
    arch_id="arctic-480b",
    family="lm",
    config=CONFIG,
    shapes=R.lm_shapes(microbatches_train=16),
    source="hf:Snowflake/snowflake-arctic-base",
    notes="128e top-2 + dense residual; optimizer state_mode=int8",
    opt_state_mode="int8",
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="arctic-480b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=96, vocab=211, moe=True,
        n_experts=8, moe_topk=2, dense_residual=True, residual_d_ff=96,
        dtype=torch.float32, param_dtype=torch.float32, attn_chunk=32,
        remat="none")
