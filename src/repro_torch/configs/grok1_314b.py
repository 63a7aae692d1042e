"""grok-1-314b [hf:xai-org/grok-1; unverified] — MoE 8 experts top-2.

64L, d_model=6144, 48 q-heads (GQA kv=8), expert d_ff=32768, vocab=131072.
Only 8 experts: TP shards each expert's d_ff (expert_shard='ffn') instead
of the expert dim.
"""

import torch

from repro_torch.configs import registry as R
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="grok-1-314b",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab=131072,
    moe=True,
    n_experts=8,
    moe_topk=2,
    expert_shard="ffn",          # 8 experts < 16-way TP: shard d_ff
    capacity_factor=1.25,
    rope_theta=1e4,
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
    attn_chunk=1024,
    remat="full",
)

ARCH = R.ArchSpec(
    arch_id="grok-1-314b",
    family="lm",
    config=CONFIG,
    shapes=R.lm_shapes(microbatches_train=16),
    source="hf:xai-org/grok-1 (unverified)",
    notes="optimizer state_mode=int8; expert d_ff sharded over TP",
    opt_state_mode="int8",
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="grok-1-314b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=257, moe=True,
        n_experts=4, moe_topk=2, expert_shard="ffn",
        dtype=torch.float32, param_dtype=torch.float32, attn_chunk=32,
        remat="none")
