"""The port's models: the flagship Transformer+CNN regressor and its fusion
heads and the graph regressors (``gnn.py``), with parameters on a leading
fold axis (``fold.py``), and a loader of flax parameter trees
(``convert.py``)."""

from bbbp_tpu_torch.models.fusion import (AttentionFusion,
                                          MultiHeadAttentionFusion,
                                          MultiModalAttentionFusion)
from bbbp_tpu_torch.models.transformer_cnn import (DegenerateEncoderLayer,
                                                   ImageCNN,
                                                   MultiModalRegressor,
                                                   TokenEncoderLayer)

__all__ = [
    "AttentionFusion",
    "MultiHeadAttentionFusion",
    "MultiModalAttentionFusion",
    "DegenerateEncoderLayer",
    "TokenEncoderLayer",
    "ImageCNN",
    "MultiModalRegressor",
]
