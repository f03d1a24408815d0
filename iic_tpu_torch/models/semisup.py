"""The semi-supervised finetune's head and model
(``iic_tpu/models/semisup.py``: ``SupHead5Head``).

``SupHead5Head`` maps trunk features to logits: Linear(dlen, 2048) ->
BatchNorm1d -> ReLU -> Linear(2048, gt_k), no softmax, both Linears with
the N(0, 0.01) init and zero biases. It runs in f32 whatever the trunk's
dtype: the features are cast to f32 first, as the JAX head casts them.
``SemisupNet`` puts a pretrained clustering net and the head together, so
that one ``state_dict`` and one optimiser (a parameter group each, for
the trunk's and the head's learning rates) cover both.
"""

import torch.nn as nn

from iic_tpu_torch.models.layers import linear_init_

HIDDEN = 2048


class SupHead5Head(nn.Module):
    """(B, dlen) features -> (B, gt_k) logits. BatchNorm1d follows
    ``batchnorm_track`` as the trunk's BNs do: running statistics in eval
    when it tracks them, batch statistics always when it does not."""

    def __init__(self, dlen, gt_k, batchnorm_track=True):
        super().__init__()
        self.linear1 = linear_init_(nn.Linear(dlen, HIDDEN))
        self.bn = nn.BatchNorm1d(HIDDEN, eps=1e-5, momentum=0.1,
                                 track_running_stats=batchnorm_track)
        self.relu = nn.ReLU(inplace=True)
        self.linear2 = linear_init_(nn.Linear(HIDDEN, gt_k))

    def forward(self, feats):
        x = self.relu(self.bn(self.linear1(feats.float())))
        return self.linear2(x)


class SemisupNet(nn.Module):
    """``net`` (a clustering net of ``models``) read as a feature trunk
    (``trunk_features``; ``penultimate_features``: the ResNet's features
    before layer4), then ``head``: images -> logits."""

    def __init__(self, net, head, penultimate_features=False):
        super().__init__()
        self.net = net
        self.head = head
        self.penultimate_features = penultimate_features

    def features(self, x):
        return self.net(x, trunk_features=True,
                        penultimate_features=self.penultimate_features)

    def forward(self, x):
        return self.head(self.features(x))
