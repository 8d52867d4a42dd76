"""The port's models: the flagship Transformer+CNN regressor and its fusion
heads, the graph regressors (``gnn.py``), SMILES-BERT (``bert.py``), the
dual-branch MLP (``mlp.py``) and the flow classifier (``flow.py``), with
parameters on a leading fold axis (``fold.py``), and a loader of flax
parameter trees and its inverse (``convert.py``)."""

from bbbp_tpu_torch.models.bert import BertEncoder, BertRegressor
from bbbp_tpu_torch.models.flow import FlowLayer, FlowModel
from bbbp_tpu_torch.models.fusion import (AttentionFusion,
                                          MultiHeadAttentionFusion,
                                          MultiModalAttentionFusion)
from bbbp_tpu_torch.models.mlp import DualBranchMLP
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
    "BertEncoder",
    "BertRegressor",
    "DualBranchMLP",
    "FlowLayer",
    "FlowModel",
]
