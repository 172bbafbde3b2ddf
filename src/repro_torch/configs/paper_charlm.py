"""The paper's own workload: character-aware CNN-LSTM next-word LM
(Kim et al. 2016, as used in Green Federated Learning §3.2).

Char-CNN word encoder -> 2-layer LSTM -> MLP decoder -> softmax over a
fixed word vocabulary: 15,560,704 parameters at this width.
"""
from repro_torch.configs.base import CHARLM, ModelConfig

CONFIG = ModelConfig(
    name="paper-charlm",
    family=CHARLM,
    num_layers=2,              # LSTM layers
    d_model=512,               # word embedding / LSTM input dim
    num_heads=0,
    num_kv_heads=0,
    d_ff=512,                  # MLP decoder hidden
    vocab_size=16384,          # word vocab
    char_vocab=256,
    char_emb=16,
    cnn_filters=((1, 32), (2, 32), (3, 64), (4, 128), (5, 256), (6, 512)),
    lstm_hidden=512,
    max_word_len=16,
    max_context=64,            # words per example (keyboard-style)
    citation="Kim et al. 2016; Green FL paper §3.2",
)
