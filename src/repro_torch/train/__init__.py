"""repro_torch.train — the full-graph trainer (``gnn.train_gnn``) and the
minibatch trainer with host or device sampling and exact layer-wise
inference (``gnn_minibatch``), and the LM serving step factories
(``lm.make_prefill_step`` / ``lm.make_decode_step``)."""
from repro_torch.train.gnn import GNNTrainResult, train_gnn
from repro_torch.train.gnn_minibatch import (MinibatchTrainResult,
                                             layerwise_inference,
                                             train_gnn_minibatch)

__all__ = ["train_gnn", "GNNTrainResult", "train_gnn_minibatch",
           "MinibatchTrainResult", "layerwise_inference"]
