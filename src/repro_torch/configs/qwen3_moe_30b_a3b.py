"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4: 8 q heads a
kv head) head_dim=128, 128 experts top-8 of d_ff 768 (capacity factor
1.25), qk-norm, untied, vocab=151936 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.models.common import LayerGroup, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
        head_dim=128, d_ff=768, vocab_size=151936,
        groups=(LayerGroup(("attn_moe",), 48),),
        mlp_act="silu", rope_theta=1000000.0, qk_norm=True,
        moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
        tie_embeddings=False,
        attn_mode="heads",
    )


def cut(num_layers: int = 12) -> ModelConfig:
    """The full-width model cut to ``num_layers`` layers: 12 of 48 are
    about 8.1 B parameters, 16 GB in bf16, what one 80 GB card builds and
    serves beside its caches (the 48 layers' 61 GB of bf16 weights leave
    no room for the f32 draw of the stacked experts, 38.7 GB at full
    depth)."""
    return config().scaled(num_layers=num_layers,
                           groups=(LayerGroup(("attn_moe",), num_layers),))


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=256, groups=(LayerGroup(("attn_moe",), 2),),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64))
