"""Shared model building blocks (``iic_tpu/models/layers.py``).

BatchNorm is ``nn.BatchNorm2d(momentum=0.1, eps=1e-5)``: batch statistics
in training (with the unbiased running-variance update), running statistics
in eval when ``track_running_stats``, batch statistics always otherwise --
the JAX ``BatchNorm`` semantics (``--bn_sync``: ``SyncBatchNorm2d``,
its statistics over the ranks of a mesh). Convs get the Kaiming-normal
init with relu gain, fan-in for the VGG nets and fan-out for the ResNets;
Linear layers N(0, 0.01) with zero bias.

Compute dtype, as the flax modules have it: parameters and BN running
statistics stay f32; a ``Conv2d`` casts its input and weight to its
``compute_dtype`` and returns that dtype; BN takes the compute-dtype
tensor as it is (it reduces in f32 with its f32 affine parameters and
returns the input's dtype); the heads cast their input to f32 and stay
full f32, so the softmax outputs are f32 in either dtype.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name):
    """``--model_dtype`` -> the torch dtype; any other name raises."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"model_dtype {name!r}: expected one of "
                         f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (f32 parameters) that runs in ``compute_dtype``: input
    and weight are cast, the output stays in that dtype (flax's
    ``nn.Conv(dtype=..., param_dtype=float32)``). The casts are no-ops in
    f32, and the weight's gradient reaches it in f32."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), self.bias)


def kaiming_normal_fan_in_(weight):
    """Kaiming-normal, fan-in, relu gain, untruncated."""
    return nn.init.kaiming_normal_(weight, mode="fan_in",
                                   nonlinearity="relu")


def kaiming_normal_fan_out_(weight):
    """Kaiming-normal, fan-out, relu gain, untruncated (the ResNets)."""
    return nn.init.kaiming_normal_(weight, mode="fan_out",
                                   nonlinearity="relu")


def linear_init_(linear, std=0.01):
    """The reference's ``weight.data.normal_(0, 0.01)``, zero bias."""
    nn.init.normal_(linear.weight, 0.0, std)
    nn.init.zeros_(linear.bias)
    return linear


def max_pool_2x2_pad1():
    """``MaxPool2d(2, stride 2, padding 1)``; torch pads with -inf, so the
    padding never wins the max."""
    return nn.MaxPool2d(kernel_size=2, stride=2, padding=1)


def batch_norm(features, track_running_stats=True):
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1,
                          track_running_stats=track_running_stats)


def batch_norm_over(bn, x, mesh, update_running=False):
    """``bn`` (a ``nn.BatchNorm2d``) on ``x`` by batch statistics taken over
    the ranks of ``mesh`` (this rank's rows alone without one): each rank's
    per-channel mean and mean of squares, averaged over the ranks by one
    differentiable all-reduce, var = mean2 - mean^2 (the JAX
    ``BatchNorm``'s formula). With ``update_running`` the running mean and
    the unbiased running variance over the global count take the
    momentum step. Computes in f32, returns ``x``'s dtype."""
    from iic_tpu_torch.parallel.mesh import all_reduce_stats

    xf = x.float()
    dims = (0, 2, 3)
    n = x.numel() // x.shape[1]
    moments = torch.cat([xf.mean(dims), (xf * xf).mean(dims)])
    if mesh is not None:
        moments = all_reduce_stats(moments, mesh) / mesh.size
        n *= mesh.size
    mean, mean2 = moments.chunk(2)
    var = mean2 - mean * mean
    if update_running:
        m = bn.momentum
        with torch.no_grad():
            bn.num_batches_tracked += 1
            bn.running_mean.mul_(1 - m).add_(m * mean)
            bn.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
    shape = (1, -1, 1, 1)
    y = (xf - mean.view(shape)) * torch.rsqrt(var + bn.eps).view(shape)
    if bn.affine:
        y = y * bn.weight.view(shape) + bn.bias.view(shape)
    return y.to(x.dtype)


class SyncBatchNorm2d(nn.BatchNorm2d):
    """``--bn_sync``'s BatchNorm (``iic_tpu/models/layers.py``'s
    ``BatchNorm`` with an ``axis_name``): in a training forward under
    autograd, ``batch_norm_over`` the ranks of ``mesh``, the running
    statistics updated. Without a mesh the same formula runs on the rank's
    own rows.

    Other forwards (eval mode, or a train-mode eval forward under
    ``no_grad``) are ``nn.BatchNorm2d``'s; the sharded eval
    (``parallel.mesh.make_sharded_eval``) takes the batch statistics of
    those over the ranks itself. Parameters and buffers are
    ``nn.BatchNorm2d``'s, so checkpoints load either way.
    ``nn.SyncBatchNorm`` refuses CPU tensors, so the gloo ranks of the
    tests could not run it."""

    def __init__(self, *args, mesh=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.mesh = mesh

    def forward(self, x):
        if not (self.training and torch.is_grad_enabled()):
            return super().forward(x)
        return batch_norm_over(self, x, self.mesh, self.track_running_stats)


def sync_batch_norm(module, mesh):
    """Replace, in place, every ``nn.BatchNorm2d`` of ``module`` by a
    ``SyncBatchNorm2d`` over ``mesh`` with its parameters and buffers.
    Returns ``module``."""
    for name, child in module.named_children():
        if type(child) is nn.BatchNorm2d:
            synced = SyncBatchNorm2d(
                child.num_features, eps=child.eps, momentum=child.momentum,
                affine=child.affine,
                track_running_stats=child.track_running_stats, mesh=mesh)
            synced.load_state_dict(child.state_dict())
            setattr(module, name, synced.to(next(child.parameters()).device)
                    if child.affine else synced)
        else:
            sync_batch_norm(child, mesh)
    return module


class MultiConvSoftmaxHead(nn.Module):
    """``num_sub_heads`` parallel (1x1 conv -> Softmax2d -> bilinear upsample
    to ``input_sz``) heads, the reference ``SegmentationNet10aHead``. Keeps
    its quirk: the 1x1 conv has padding=1, which adds a one-pixel ring of
    zero logits (a uniform softmax) before the upsample. The parameters
    are the reference's (``heads.<s>.0.weight``, (K, C, 1, 1)); the forward
    is the JAX head's one f32 einsum over all sub-heads, as a cuBLAS matmul
    with TF32 off (PyTorch's default and the trainers'), so the head's
    precision does not follow cuDNN's TF32 flag, in a process or in an
    exported graph.

    Input (B, C, H, W) -> output (num_sub_heads, B, K, input_sz, input_sz).
    """

    def __init__(self, in_channels, output_k, num_sub_heads, input_sz):
        super().__init__()
        self.input_sz = input_sz
        self.output_k = output_k
        self.heads = nn.ModuleList([
            nn.Sequential(nn.Conv2d(in_channels, output_k, kernel_size=1,
                                    stride=1, dilation=1, padding=1,
                                    bias=False),
                          nn.Softmax2d())
            for _ in range(num_sub_heads)])
        for head in self.heads:
            kaiming_normal_fan_in_(head[0].weight)

    def forward(self, x):
        # f32 input whatever the trunk's dtype, as the JAX head. A bmm of
        # (S*K, C) by each image's (C, H*W) keeps the logits and the
        # input's gradient NCHW-contiguous (an einsum or a broadcast
        # matmul hands the trunk a channels-last gradient)
        w = torch.cat([head[0].weight.flatten(1) for head in self.heads])
        b, _, h, wd = x.shape
        logits = torch.bmm(w.expand(b, -1, -1),
                           x.float().flatten(2)).view(b, -1, h, wd)
        logits = F.pad(logits, (1, 1, 1, 1))  # the zero ring of padding=1
        hp, wp = h + 2, wd + 2
        s, k = len(self.heads), self.output_k
        probs = logits.view(b, s, k, hp, wp).softmax(dim=2)
        out = F.interpolate(probs.transpose(0, 1).reshape(s * b, k, hp, wp),
                            size=(self.input_sz, self.input_sz),
                            mode="bilinear", align_corners=False)
        return out.view(s, b, k, self.input_sz, self.input_sz)


class MultiDenseHead(nn.Module):
    """``num_sub_heads`` parallel Linear + softmax heads, the reference's
    ``heads`` ModuleList of ``Sequential(Linear, Softmax)``; the JAX
    package's one einsum with a leading sub-head axis.

    Input (B, D), cast to the parameters' dtype (f32) -> output
    (num_sub_heads, B, K). The trainers keep cuBLAS out of TF32, so the
    heads run in full f32 as in the JAX package.
    """

    def __init__(self, in_features, output_k, num_sub_heads):
        super().__init__()
        self.heads = nn.ModuleList([
            nn.Sequential(linear_init_(nn.Linear(in_features, output_k)),
                          nn.Softmax(dim=1))
            for _ in range(num_sub_heads)])

    def forward(self, x):
        x = x.to(self.heads[0][0].weight.dtype)
        return torch.stack([head(x) for head in self.heads])
