"""repro_torch.train — the full-graph trainer (``gnn.train_gnn``) and the
minibatch trainer with host or device sampling and exact layer-wise
inference (``gnn_minibatch``), the LM train step (``lm.TrainState``,
``lm.make_train_state``, ``lm.make_train_step``) and the LM serving step
factories (``lm.make_prefill_step`` / ``lm.make_decode_step``)."""
from repro_torch.train.gnn import GNNTrainResult, train_gnn
from repro_torch.train.gnn_minibatch import (MinibatchTrainResult,
                                             layerwise_inference,
                                             train_gnn_minibatch)
from repro_torch.train.lm import (TrainState, make_decode_step,
                                  make_prefill_step, make_train_state,
                                  make_train_step)

__all__ = ["train_gnn", "GNNTrainResult", "train_gnn_minibatch",
           "MinibatchTrainResult", "layerwise_inference", "TrainState",
           "make_train_state", "make_train_step", "make_prefill_step",
           "make_decode_step"]
