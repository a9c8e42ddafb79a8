"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) head_dim=128,
8 experts top-2 of d_ff 14336, sliding-window attention over 4096
positions (a ring-buffer KV cache), untied, vocab=32000
[arXiv:2401.04088]."""
from repro_torch.models.common import LayerGroup, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=32000,
        groups=(LayerGroup(("attn_moe",), 32),),
        mlp_act="silu", rope_theta=1000000.0,
        sliding_window=4096,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336),
        tie_embeddings=False,
        attn_mode="heads",
        subquadratic=True,          # SWA ring buffer: O(window) decode state
    )


def cut(num_layers: int = 4) -> ModelConfig:
    """The full-width model cut to ``num_layers`` layers: 4 of 32 are
    about 6.1 B parameters, 12 GB in bf16 (the 32 layers' 93 GB of bf16
    weights do not fit one 80 GB card)."""
    return config().scaled(num_layers=num_layers,
                           groups=(LayerGroup(("attn_moe",), num_layers),))


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, sliding_window=16,
        groups=(LayerGroup(("attn_moe",), 2),),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128))
