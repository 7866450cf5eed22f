from .layers import (
    lstm_init,
    lstm_step,
    lstm_zero_state,
    mlp_apply,
    mlp_init,
)
from .proposals import head_apply, head_init, head_kind_for, prior_param_arrays
from .dataset import Batch, OnlineDataset, PackedBatch, prune_trace
from .inference_network import InferenceNetwork
from .inference_network_feedforward import InferenceNetworkFeedForward
from .inference_network_lstm import InferenceNetworkLSTM

__all__ = [
    "mlp_init",
    "mlp_apply",
    "lstm_init",
    "lstm_step",
    "lstm_zero_state",
    "head_kind_for",
    "head_init",
    "head_apply",
    "prior_param_arrays",
    "Batch",
    "OnlineDataset",
    "PackedBatch",
    "prune_trace",
    "InferenceNetwork",
    "InferenceNetworkFeedForward",
    "InferenceNetworkLSTM",
]
