"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B family, scaled per assignment]:
94L d_model=4096 64H (GQA kv=4) expert_ff=1536 vocab=151936, MoE 128e top-8,
qk-norm."""
from repro_torch.configs.registry import ArchSpec, _lm_cells, register
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=0, vocab=151936, qk_norm=True, rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert_ff=1536,
                  capacity_factor=1.25),
)

SMOKE = TransformerConfig(
    name="qwen3-moe-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=0, vocab=256, qk_norm=True,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert_ff=32, capacity_factor=2.0),
    q_chunk=16, kv_chunk=16, loss_chunk=16, remat=False,
)

register(ArchSpec(
    arch_id="qwen3-moe-235b-a22b", family="lm", config=FULL, smoke=SMOKE,
    cells=_lm_cells(),
    notes="128-expert top-8 MoE; expert parallel on 'model' axis.",
))
