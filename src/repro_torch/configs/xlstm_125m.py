"""xlstm-125m [ssm]: 12 layers x 768, 4 heads, mLSTM:sLSTM 3:1 interleave
(the xLSTM paper's xLSTM[3:1]; the FFNs are inside the blocks), vocab
50304, tied embeddings [arXiv:2405.04517]."""
from repro_torch.models.common import LayerGroup, ModelConfig, XLSTMConfig

_PERIOD = ("mlstm", "mlstm", "mlstm", "slstm")


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304,
        groups=(LayerGroup(_PERIOD, 3),),
        xlstm=XLSTMConfig(),
        tie_embeddings=True,
        attn_mode="sequence",
        subquadratic=True,          # recurrent: O(1) decode state
    )


def smoke() -> ModelConfig:
    return config().scaled(
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        vocab_size=256, groups=(LayerGroup(_PERIOD, 1),),
        xlstm=XLSTMConfig(chunk=8))
