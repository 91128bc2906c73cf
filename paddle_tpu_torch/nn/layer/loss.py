"""Loss layers (port of the reference's ``nn/layer/loss.py``): each holds
its options and calls its functional of :mod:`..functional`, which keeps
the reference's formulas and reductions."""

from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss", "MarginRankingLoss",
           "CosineEmbeddingLoss", "CTCLoss", "GaussianNLLLoss", "PoissonNLLLoss",
           "HingeEmbeddingLoss", "SoftMarginLoss", "MultiLabelSoftMarginLoss",
           "MultiMarginLoss", "TripletMarginLoss", "TripletMarginWithDistanceLoss"]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean", soft_label=False,
                 axis=-1, use_softmax=True, label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index, reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               use_softmax=self.use_softmax,
                               label_smoothing=self.label_smoothing)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean", name=None):
        super().__init__()
        self.weight, self.ignore_index, self.reduction = weight, ignore_index, reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self.weight, self.ignore_index, self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight, self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None, name=None):
        super().__init__()
        self.weight, self.reduction, self.pos_weight = weight, reduction, pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(logit, label, self.weight, self.reduction,
                                                  self.pos_weight)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction, self.delta = reduction, delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean", log_target=False):
        super().__init__()
        self.reduction, self.log_target = reduction, log_target

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction, self.log_target)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin, self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin, self.reduction)


class CTCLoss(Layer):
    """``F.ctc_loss`` over raw logits [T, B, C]."""

    def __init__(self, blank: int = 0, reduction: str = "mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times: bool = False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction=self.reduction,
                          norm_by_times=norm_by_times)


class GaussianNLLLoss(Layer):
    def __init__(self, full: bool = False, epsilon: float = 1e-6,
                 reduction: str = "mean", name=None):
        super().__init__()
        self.full, self.epsilon, self.reduction = full, epsilon, reduction

    def forward(self, input, label, variance):
        return F.gaussian_nll_loss(input, label, variance, self.full,
                                   self.epsilon, self.reduction)


class PoissonNLLLoss(Layer):
    def __init__(self, log_input: bool = True, full: bool = False,
                 epsilon: float = 1e-8, reduction: str = "mean", name=None):
        super().__init__()
        self.log_input, self.full = log_input, full
        self.epsilon, self.reduction = epsilon, reduction

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, self.log_input, self.full,
                                  self.epsilon, self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin: float = 1.0, reduction: str = "mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin, self.reduction)


class SoftMarginLoss(Layer):
    def __init__(self, reduction: str = "mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, self.reduction)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction: str = "mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label, self.weight,
                                              self.reduction)


class MultiMarginLoss(Layer):
    def __init__(self, p: int = 1, margin: float = 1.0, weight=None,
                 reduction: str = "mean", name=None):
        super().__init__()
        self.p, self.margin, self.weight = p, margin, weight
        self.reduction = reduction

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, self.p, self.margin,
                                   self.weight, self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin: float = 1.0, p: float = 2.0, epsilon: float = 1e-6,
                 swap: bool = False, reduction: str = "mean", name=None):
        super().__init__()
        self.margin, self.p, self.epsilon = margin, p, epsilon
        self.swap, self.reduction = swap, reduction

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, self.margin,
                                     self.p, self.epsilon, self.swap,
                                     self.reduction)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin: float = 1.0,
                 swap: bool = False, reduction: str = "mean", name=None):
        super().__init__()
        self.distance_function = distance_function
        self.margin, self.swap, self.reduction = margin, swap, reduction

    def forward(self, input, positive, negative):
        return F.triplet_margin_with_distance_loss(
            input, positive, negative, self.distance_function, self.margin,
            self.swap, self.reduction)
