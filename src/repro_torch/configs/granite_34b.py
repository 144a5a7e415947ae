"""granite-34b [arXiv:2405.04324]: 88L d_model=6144 48H MQA (kv=1)
d_ff=24576 vocab=49152 — gpt-bigcode style 2-matmul GELU MLP."""
from repro_torch.configs.registry import ArchSpec, _lm_cells, register
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="granite-34b",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_head=128,
    d_ff=24576, vocab=49152, glu=False, rope_theta=1e4,
)

SMOKE = TransformerConfig(
    name="granite-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=1, d_head=8,
    d_ff=256, vocab=256, glu=False,
    q_chunk=16, kv_chunk=16, loss_chunk=16, remat=False,
)

register(ArchSpec(
    arch_id="granite-34b", family="lm", config=FULL, smoke=SMOKE,
    cells=_lm_cells(),
    notes="MQA (kv=1): KV cache cannot shard on heads; decode shards on "
          "batch only.",
))
