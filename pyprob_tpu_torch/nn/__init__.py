from .layers import (
    cnn2d5c_apply,
    cnn2d5c_init,
    cnn3d5c_apply,
    cnn3d5c_init,
    lstm_init,
    lstm_step,
    lstm_zero_state,
    mlp_apply,
    mlp_init,
)
from .proposals import head_apply, head_init, head_kind_for, prior_param_arrays
from .optimizer_larc import LARC, larc_scale
from .dataset import (
    Batch,
    DistributedTraceBatchSampler,
    OfflineDataset,
    OfflineDatasetFile,
    OnlineDataset,
    PackedBatch,
    TraceBatchSampler,
    TraceSampler,
    prune_trace,
)
from .inference_network import InferenceNetwork
from .inference_network_feedforward import InferenceNetworkFeedForward
from .inference_network_lstm import InferenceNetworkLSTM

__all__ = [
    "mlp_init",
    "mlp_apply",
    "lstm_init",
    "lstm_step",
    "lstm_zero_state",
    "cnn2d5c_init",
    "cnn2d5c_apply",
    "cnn3d5c_init",
    "cnn3d5c_apply",
    "head_kind_for",
    "head_init",
    "head_apply",
    "prior_param_arrays",
    "LARC",
    "larc_scale",
    "Batch",
    "OnlineDataset",
    "OfflineDataset",
    "OfflineDatasetFile",
    "TraceSampler",
    "TraceBatchSampler",
    "DistributedTraceBatchSampler",
    "PackedBatch",
    "prune_trace",
    "InferenceNetwork",
    "InferenceNetworkFeedForward",
    "InferenceNetworkLSTM",
]
