"""deepseek-v2-lite-16b [arXiv:2405.04434]: 27L d_model=2048 16H MLA
(kv_lora=512) expert_ff=1408 vocab=102400, MoE 64e top-6 + 2 shared.

Assignment note: the spec lists both '64e top-6' and '160 routed'; the
HF DeepSeek-V2-Lite card has 64 routed experts — we follow 64. All layers
are MoE (the real model's first dense layer is folded into the uniform
layer stack; DESIGN.md §8)."""
from repro_torch.configs.registry import ArchSpec, _lm_cells, register
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import MLAConfig, TransformerConfig

FULL = TransformerConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=0, vocab=102400, rope_theta=1e4,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_expert_ff=1408, n_shared=2,
                  d_shared_ff=2816, capacity_factor=1.25),
)

SMOKE = TransformerConfig(
    name="deepseek-v2-lite-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=0, vocab=256,
    mla=MLAConfig(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                  v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_expert_ff=32, n_shared=1,
                  d_shared_ff=32, capacity_factor=2.0),
    q_chunk=16, kv_chunk=16, loss_chunk=16, remat=False,
)

register(ArchSpec(
    arch_id="deepseek-v2-lite-16b", family="lm", config=FULL, smoke=SMOKE,
    cells=_lm_cells(),
    notes="MLA: decode attends against compressed c_kv cache (absorbed form);"
          " cache is [S, kv_lora+rope] instead of [S, H, 2*dh].",
))
