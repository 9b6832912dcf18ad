"""xlstm-350m: xLSTM with sLSTM + mLSTM blocks (ratio 3:1).
[arXiv:2405.04517; unverified]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                 # xLSTM blocks own their projections
    vocab=50304,
    head_dim=256,
    slstm_every=4,          # repeating unit [mLSTM x3, sLSTM x1]
    ssm_expand=2,
    notes="sLSTM + mLSTM blocks; recurrent O(1) decode state -> long_500k runs",
)
