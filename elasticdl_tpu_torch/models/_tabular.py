"""The feature-column DNN of the heart and census models:
``DenseFeatures -> Dense(16, relu) -> Dense(16, relu) -> Dense(1,
sigmoid)``, with flax's names (``DenseFeatures_0``, ``Dense_0..2``) in
``utils/flax_weights.py``.  The output is the f32 probability ``(batch,
1)``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.feature_column import DenseFeatures
from elasticdl_tpu_torch.layers.initializers import flax_default_init_

HIDDEN = 16


class FeatureColumnDNN(nn.Module):
    def __init__(self, columns: tuple):
        super().__init__()
        self.dense_features = DenseFeatures(columns)
        self.dense_0 = nn.Linear(self.dense_features.output_dim, HIDDEN)
        self.dense_1 = nn.Linear(HIDDEN, HIDDEN)
        self.dense_2 = nn.Linear(HIDDEN, 1)
        for layer in (self.dense_0, self.dense_1, self.dense_2):
            flax_default_init_(layer)

    def forward(self, features, training: bool = False, generator=None):
        """The model has no dropout and no statistics: ``training``
        changes nothing."""
        x = self.dense_features(features, device=self.dense_0.weight.device)
        x = F.relu(self.dense_0(x))
        x = F.relu(self.dense_1(x))
        return torch.sigmoid(self.dense_2(x))


def binary_cross_entropy(labels, probs):
    """Binary cross entropy on probabilities clipped to ``[1e-7, 1 -
    1e-7]``, the JAX package's, averaged over ``probs``' elements."""
    labels = torch.as_tensor(labels, device=probs.device).to(torch.float32)
    probs = torch.clamp(probs.float(), 1e-7, 1 - 1e-7)
    labels = labels.reshape(probs.shape)
    return -(labels * torch.log(probs) + (1 - labels) * torch.log(1 - probs)).mean()
