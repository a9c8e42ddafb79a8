"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2; Mamba:attention 7:1 interleave
(attention at index 4 of each 8-layer period), MoE on the odd layers
[arXiv:2403.19887]."""
from repro_torch.models.common import (LayerGroup, ModelConfig, MoEConfig,
                                       SSMConfig)

# one 8-layer Jamba period; layers 1, 3, 5, 7 are MoE, layer 4 is attention
PERIOD = ("mamba", "mamba_moe", "mamba", "mamba_moe",
          "attn", "mamba_moe", "mamba", "mamba_moe")


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=65536,
        groups=(LayerGroup(PERIOD, 4),),
        mlp_act="silu", rope_theta=10000.0,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
        tie_embeddings=False,
        attn_mode="heads",
        subquadratic=True,          # 28 of 32 layers are O(1)-state Mamba
    )


def one_period() -> ModelConfig:
    """The full-width model cut to one 8-layer period (about 13.3 B
    parameters, 26.6 GB in bf16): the depth one 80 GB card serves."""
    return config().scaled(num_layers=8, groups=(LayerGroup(PERIOD, 1),))


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, groups=(LayerGroup(PERIOD, 1),),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2, chunk=8))
