"""The semi-supervised finetune of the port against the JAX package, its
pieces: TenCrop, SupHead5, the trunk features, the semisup head B, the
block-averaged eval and a ten-step lockstep of the finetune step. Inputs
and weights are made from numpy seeds; each tolerance is stated where it
is used. The CLI runs are in test_torch_semisup_cli.py."""

import copy
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iic_tpu import models as jmodels
from iic_tpu.data import semisup as jsemi
from iic_tpu.models.semisup import SupHead5Head as JaxSupHead5Head
from iic_tpu.ops.sobel import sobel_process as jax_sobel
from iic_tpu.parallel.train_step import TrainState, make_semisup_train_step
from iic_tpu.train import semisup_trainer as jtrainer
from iic_tpu.train.config import SemisupConfig as JaxSemisupConfig
from iic_tpu_torch import models as tmodels
from iic_tpu_torch.compat.flax_bridge import load_cluster_net, load_sup_head
from iic_tpu_torch.data import semisup as tsemi
from iic_tpu_torch.models.semisup import SemisupNet, SupHead5Head
from iic_tpu_torch.ops.sobel import sobel_process
from iic_tpu_torch.parallel.train_step import (
    frozen_batch_stats, make_semisup_optimizer,
    make_semisup_train_step as port_step, set_lr_mult)
from iic_tpu_torch.train import semisup_trainer as ttrainer
from iic_tpu_torch.train.config import SemisupConfig
from test_torch_cluster_models import random_flax_variables

RTOL, ATOL = 1e-4, 1e-5  # f32 forwards in different op orders
# The ResNet's train-mode features against JAX's, as a share of their
# largest: JAX's BatchNorm (var = E[x^2] - E[x]^2 in f32) leaves a float64
# run of the port by up to 2.5e-5 of max at layer3 (the port's f32 run by
# 2.9e-6), measured on this file's nets
FEAT_TRAIN = 3e-5
SZ = 24


# ------------------------------------------------------------- TenCrop

def test_ten_crop_equals_jax_bit_for_bit():
    """tests/test_semisup.py's case: a 96^2 rgb image, crops of 64, in
    TenCrop's order (the centre's offset floored), and a batch of two."""
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (2, 96, 96, 3)).astype(np.float32)
    got = tsemi.ten_crop(torch.from_numpy(imgs), 64).numpy()
    assert got.shape == (2, 10, 64, 64, 3)
    for i in range(2):
        ref = np.asarray(jsemi.ten_crop(jnp.asarray(imgs[i]), 64))
        assert np.array_equal(got[i], ref)
    a = imgs[0]
    assert np.array_equal(got[0, 4], a[16:80, 16:80])
    assert np.array_equal(got[0, 5], a[:, ::-1][:64, :64])
    odd = rng.uniform(0, 1, (1, 33, 35, 1)).astype(np.float32)
    assert np.array_equal(
        tsemi.ten_crop(torch.from_numpy(odd), 24)[0].numpy(),
        np.asarray(jsemi.ten_crop(jnp.asarray(odd[0]), 24)))


@pytest.mark.parametrize("include_rgb,grey_append", [(True, True),
                                                     (False, True),
                                                     (False, False)])
def test_tencrop_batch_fn_equals_jax_bit_for_bit(include_rgb, grey_append):
    """tests/test_semisup.py's batch of three uint8 96^2 images at 64:
    contiguous blocks of 10 with the grey append (or none, the greyscale
    path), NCHW, equal to JAX's bit for bit."""
    rng = np.random.default_rng(1)
    c = 3 if grey_append else 1
    imgs = rng.integers(0, 255, (3, 96, 96, c), dtype=np.uint8)
    got = tsemi.make_tencrop_batch_fn(64, include_rgb, grey_append)(
        torch.from_numpy(imgs)).numpy()
    ref = np.asarray(jsemi.make_tencrop_batch_fn(64, include_rgb,
                                                 grey_append)(
        jnp.asarray(imgs)))
    assert got.shape == ref.shape == (
        30, 4 if include_rgb else 1, 64, 64)
    assert np.array_equal(got, ref)


def test_train_loader_batches_are_jaxs():
    """The finetune loader's epochs hold JAX's index sets, in its order,
    the ragged last batch kept."""
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 255, (23, 8, 8, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, 23)
    port = tsemi.SemisupTrainLoader(imgs, labels, 5, seed=3)
    ref = jsemi.SemisupTrainLoader(None, imgs, labels, 5, seed=3)
    assert len(port) == len(ref) == 5
    for e in (0, 4):
        for (pi, pl, _), (ri, rl, _) in zip(port.epoch(e), ref.epoch(e)):
            assert np.array_equal(pi.numpy(), np.asarray(ri))
            assert np.array_equal(pl.numpy(), np.asarray(rl))


# -------------------------------------------------------------- the head

def _head_variables(dlen, gt_k, seed=0, k2=0.05):
    """SupHead5Head's flax variables from numpy: N(0, 0.01) kernels (N(0,
    ``k2``) for the second, so the logits are not ~0), random biases, BN
    affine and running statistics."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=0.1, loc=0.0):
        return np.asarray(loc + scale * rng.standard_normal(shape),
                          np.float32)

    params = {"kernel1": f(dlen, 2048, scale=0.01), "bias1": f(2048),
              "BatchNorm_0": {"scale": f(2048, loc=1.0), "bias": f(2048)},
              "kernel2": f(2048, gt_k, scale=k2), "bias2": f(gt_k)}
    stats = {"BatchNorm_0": {"mean": f(2048, scale=0.05),
                             "var": np.asarray(rng.uniform(0.5, 1.5, 2048),
                                               np.float32)}}
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("track", [True, False])
@pytest.mark.parametrize("train", [True, False])
def test_sup_head5_matches_jax(track, train):
    """Logits in train- and eval-mode BN, and the running statistics after
    a train-mode forward, within rtol 1e-4 / atol 1e-5 of JAX's."""
    dlen, gt_k = 96, 10
    variables = _head_variables(dlen, gt_k)
    if not track:
        variables = {"params": variables["params"]}
    jhead = JaxSupHead5Head(gt_k=gt_k, batchnorm_track=track)
    thead = load_sup_head(variables, SupHead5Head(dlen, gt_k, track))
    x = np.random.default_rng(3).standard_normal((16, dlen)).astype(
        np.float32)
    if train and track:
        ref, upd = jhead.apply(variables, x, train=True,
                               mutable=["batch_stats"])
    else:
        ref = jhead.apply(variables, x, train=train)
    thead.train(train)
    with torch.no_grad():
        got = thead(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert got.dtype == torch.float32
    if train and track:
        st = upd["batch_stats"]["BatchNorm_0"]
        np.testing.assert_allclose(thead.bn.running_mean.numpy(),
                                   st["mean"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(thead.bn.running_var.numpy(),
                                   st["var"], rtol=RTOL, atol=ATOL)


def test_sup_head5_init_is_the_references():
    head = SupHead5Head(500, 10)
    assert head.linear1.weight.shape == (2048, 500)
    assert head.linear2.weight.shape == (10, 2048)
    for lin in (head.linear1, head.linear2):
        assert abs(float(lin.weight.detach().std()) - 0.01) < 1e-3
        assert not lin.bias.detach().any()
    assert isinstance(head.bn, torch.nn.BatchNorm1d)


# --------------------------------------------------------- trunk features

def _net_cfg(arch, track=True, semisup=False, sz=SZ):
    return SimpleNamespace(arch=arch, in_channels=2, output_k=7,
                           output_k_A=7, output_k_B=5, num_sub_heads=2,
                           input_sz=sz, batchnorm_track=track,
                           semisup=semisup, model_dtype="float32")


def _bridged(arch, track=True, semisup=False, seed=1, sz=SZ):
    cfg = _net_cfg(arch, track, semisup, sz)
    jnet = jmodels.build(arch, cfg)
    heads = ("A", "B") if arch.endswith("TwoHead") else None
    variables = random_flax_variables(jnet, cfg.in_channels, heads=heads,
                                      seed=seed, head_std=0.1, sz=sz)
    return jnet, variables, load_cluster_net(variables,
                                             tmodels.build(arch, cfg))


@pytest.fixture(scope="module")
def nets():
    return {arch: _bridged(arch) for arch in (
        "ClusterNet5g", "ClusterNet5gTwoHead", "ClusterNet6c",
        "ClusterNet6cTwoHead")}


def _x(seed=0, b=4):
    return np.random.default_rng(seed).random((b, 2, SZ, SZ)).astype(
        np.float32)


@pytest.mark.parametrize("arch,penult", [
    ("ClusterNet5g", False), ("ClusterNet5g", True),
    ("ClusterNet5gTwoHead", True), ("ClusterNet6c", False),
    ("ClusterNet6cTwoHead", False)])
@pytest.mark.parametrize("train", [True, False])
def test_trunk_features_match_jax(nets, arch, penult, train):
    """``trunk_features`` (and the ResNets' ``penultimate_features``) in
    train- and eval-mode BN against JAX's: rtol 1e-4, and atol 1e-5 of
    max |ref| in eval-mode BN, ``FEAT_TRAIN`` of it in train mode; at 24^2
    the ResNet's penultimate features are 256 * 4 * 4 (layer3's 4 x 4,
    flattened in NCHW order), net6c's 512 * 3 * 3. The features are not
    probabilities: the eval-mode ResNet's reach 82 here, so the absolute
    tolerance is taken relative to their largest."""
    jnet, variables, tnet = nets[arch]
    x = _x(1)
    kw = dict(trunk_features=True, penultimate_features=penult)
    if train:
        ref, _ = jnet.apply(variables, x, train=True,
                            mutable=["batch_stats"], **kw)
    else:
        ref = jnet.apply(variables, x, train=False, **kw)
    with torch.no_grad():
        if train:
            with frozen_batch_stats(tnet):  # the fixture's net is shared
                got = tnet(torch.from_numpy(x), **kw)
        else:
            got = tnet.eval()(torch.from_numpy(x), **kw)
    width = {(True, True): 256 * 16, (True, False): 512}.get(
        ("5g" in arch, penult), 512 * 9)
    assert got.shape == ref.shape == (4, width)
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL,
                               atol=(FEAT_TRAIN if train else ATOL) * scale)


def test_penultimate_features_at_64_are_20736_wide():
    """Table 3's trunk: the ResNet at 64^2 gives 256 * 9 * 9 = 20 736
    features before layer4, by ``get_dlen`` (eval BN, running statistics
    untouched)."""
    cfg = _net_cfg("ClusterNet5g")
    cfg.input_sz = 64
    net = tmodels.build(cfg.arch, cfg)
    before = [b.clone() for b in net.buffers()]
    assert ttrainer.get_dlen(net, torch.zeros((2, 2, 64, 64)), True) == 20736
    assert ttrainer.get_dlen(net, torch.zeros((2, 2, 64, 64))) == 512
    assert all(torch.equal(a, b) for a, b in zip(before, net.buffers()))
    assert net.training


@pytest.mark.parametrize("arch", ["ClusterNet6c", "ClusterNet6cTwoHead"])
def test_net6c_refuses_penultimate_features_as_jax_does(nets, arch):
    jnet, variables, tnet = nets[arch]
    with pytest.raises(ValueError, match="penultimate"):
        tnet(torch.from_numpy(_x()), penultimate_features=True)
    with pytest.raises(AssertionError):
        jnet.apply(variables, _x(), train=False, penultimate_features=True)


@pytest.mark.parametrize("arch", ["ClusterNet5gTwoHead",
                                  "ClusterNet6cTwoHead"])
def test_semisup_head_b_logits_match_jax(arch):
    """``semisup`` nets: head B is one Linear with no softmax, its logits
    within rtol 1e-4 / atol 1e-5 of the bridged JAX net's; head A still
    the softmax sub-heads."""
    jnet, variables, tnet = _bridged(arch, semisup=True, seed=2)
    assert isinstance(tnet.head_B, torch.nn.Linear)
    x = _x(2)
    tnet.eval()
    for head in "AB":
        ref = jnet.apply(variables, x, head=head, train=False)
        with torch.no_grad():
            got = tnet(torch.from_numpy(x), head=head)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)
    assert got.shape == (4, 5)


# ------------------------------------------------------ the 10-crop eval

def _jax_apply(jnet, tvars, jhead, hvars, include_rgb):
    """The JAX trainer's eval forward: sobel, trunk features, head, all in
    eval-mode BN."""
    @jax.jit
    def apply(crops):
        feats = jnet.apply(tvars, jax_sobel(crops, include_rgb),
                           train=False, trunk_features=True)
        return jhead.apply(hvars, feats, train=False)
    return apply


def _semisup_pair(seed=1, sz=SZ, k2=0.05):
    """A net6c's and a head's JAX variables and the port's ``SemisupNet``
    on the same weights."""
    jnet, tvars, tnet = _bridged("ClusterNet6c", seed=seed, sz=sz)
    dlen = 512 * (sz // 8) ** 2
    hvars = _head_variables(dlen, 10, seed=seed, k2=k2)
    model = SemisupNet(tnet, load_sup_head(hvars, SupHead5Head(dlen, 10)))
    return jnet, tvars, JaxSupHead5Head(gt_k=10), hvars, model


def test_assess_acc_block_matches_jax():
    """11 images of 32^2 (a ragged last batch of 3 at 4 images a batch),
    crops of 24 with rgb and grey, sobel: the block-averaged logits within
    rtol 1e-4 / atol 1e-5 of JAX's and the same accuracy."""
    jnet, tvars, jhead, hvars, model = _semisup_pair()
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (11, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, 11)
    jfn = jsemi.make_tencrop_batch_fn(SZ, include_rgb=False)
    japply = _jax_apply(jnet, tvars, jhead, hvars, False)
    tfn = tsemi.make_tencrop_batch_fn(SZ, include_rgb=False)

    @torch.no_grad()
    def tapply(crops):
        model.eval()
        return model(sobel_process(crops, False))

    ref_logits = np.asarray(japply(jfn(jnp.asarray(imgs)))).reshape(
        11, 10, -1).mean(axis=1)
    got_logits = ttrainer.block_logits(tapply, torch.from_numpy(imgs), tfn)
    np.testing.assert_allclose(got_logits.numpy(), ref_logits, rtol=RTOL,
                               atol=ATOL)
    labels[:6] = ref_logits.argmax(axis=1)[:6]  # some right, some not
    ref = jtrainer.assess_acc_block(japply, imgs, labels, jfn, 10,
                                    batch_images=4)
    got = ttrainer.assess_acc_block(tapply, imgs, labels, tfn, "cpu",
                                    batch_images=4)
    assert got == ref and 6 / 11 <= got < 1.0


# ------------------------------------------------------------ the step

# lr of the lockstep: the clustering locksteps' rule (their losses within
# 1e-4 a step at lr 1e-5; the JAX BatchNorm's f32 noise grows with lr),
# here trunk 1e-5 and head 1e-4
TRUNK_LR, HEAD_LR, LOCKSTEP_TOL = 1e-5, 1e-4, 1e-4


def _jax_semisup_step(jnet, jhead, trunk_lr, head_lr):
    """The JAX trainer's step on pre-augmented batches: its forward (trunk
    features, then the head, BN statistics of both updated) through
    ``make_semisup_train_step``, with its ``multi_transform`` of two
    Adams."""
    def forward(params, batch_stats, imgs, train):
        feats, upd_t = jnet.apply(
            {"params": params["trunk"], "batch_stats": batch_stats["trunk"]},
            imgs, train=train, trunk_features=True, mutable=["batch_stats"])
        logits, upd_h = jhead.apply(
            {"params": params["head"], "batch_stats": batch_stats["head"]},
            feats, train=train, mutable=["batch_stats"])
        return logits, {"trunk": upd_t["batch_stats"],
                        "head": upd_h["batch_stats"]}

    tx = optax.multi_transform(
        {"trunk": optax.inject_hyperparams(optax.adam)(trunk_lr),
         "head": optax.inject_hyperparams(optax.adam)(head_lr)},
        {"trunk": "trunk", "head": "head"})
    return tx, make_semisup_train_step(forward, lambda imgs, key: imgs, tx)


def _port_losses(model, batches, trunk_lr, head_lr):
    """The port's losses over ``batches``, the rates halved after step 5."""
    opt = make_semisup_optimizer(model, trunk_lr, head_lr)
    step = port_step(model, opt)
    out = []
    for i, (imgs, labels) in enumerate(batches):
        if i == 5:
            set_lr_mult(opt, 0.5)
        out.append(float(step((torch.from_numpy(imgs),
                               torch.from_numpy(labels)))))
    assert [g["lr"] for g in opt.param_groups] == [trunk_lr / 2, head_lr / 2]
    return out


def test_ten_step_lockstep_with_jax():
    """Ten steps of the finetune (net6c trunk at 16^2, BN tracked; SupHead5
    at 2048 -> 2048 -> 10 with the reference's N(0, 0.01) kernels) from the
    same weights on the same pre-augmented batches of 8: the JAX step
    (optax ``multi_transform`` of two Adams) and the port's (one Adam, a
    group each), the rates halved by ``_multi_set_lr_mult`` /
    ``set_lr_mult`` after step 5. The losses within ``LOCKSTEP_TOL`` at
    every step (measured: JAX and the port each within 5.3e-6 of a float64
    run of the port). With a second kernel 5x larger the steps turn
    chaotic in f32: each package leaves the float64 run by up to 3e-4. The
    check has teeth: the port with the two rates swapped leaves the
    band."""
    jnet, tvars, jhead, hvars, model = _semisup_pair(seed=5, sz=16, k2=0.01)
    tx, jstep = _jax_semisup_step(jnet, jhead, TRUNK_LR, HEAD_LR)
    params = {"trunk": tvars["params"], "head": hvars["params"]}
    state = TrainState(
        params=params, opt_state=tx.init(params),
        batch_stats={"trunk": tvars["batch_stats"],
                     "head": hvars["batch_stats"]},
        step=jnp.zeros((), jnp.int32))
    rng = np.random.default_rng(6)
    batches = [(rng.random((8, 2, 16, 16)).astype(np.float32),
                rng.integers(0, 10, 8)) for _ in range(10)]
    ref = []
    for i, (imgs, labels) in enumerate(batches):
        if i == 5:
            state = jtrainer._multi_set_lr_mult(state, 0.5)
        state, loss = jstep(state, (jnp.asarray(imgs), jnp.asarray(labels)),
                            jax.random.PRNGKey(0))
        ref.append(float(loss))
    swapped = copy.deepcopy(model)
    got = _port_losses(model, batches, TRUNK_LR, HEAD_LR)
    assert np.abs(np.subtract(got, ref)).max() <= LOCKSTEP_TOL, (got, ref)
    bad = _port_losses(swapped, batches, HEAD_LR, TRUNK_LR)
    assert np.abs(np.subtract(bad, ref)).max() > 10 * LOCKSTEP_TOL


def test_optimizer_groups_are_trunk_and_head():
    """One group each: the trunk's parameters (not the old net's
    clustering heads) and the head's."""
    _, _, _, _, model = _semisup_pair()
    opt = make_semisup_optimizer(model, 1e-4, 1e-3)
    trunk, head = (set(map(id, g["params"])) for g in opt.param_groups)
    assert trunk == set(map(id, model.net.trunk.parameters()))
    assert head == set(map(id, model.head.parameters()))
    assert [g["lr"] for g in opt.param_groups] == [1e-4, 1e-3]


def test_semisup_config_is_jaxs():
    """Every field of the JAX ``SemisupConfig``, with its default, and no
    other."""
    port = {f.name: f.default for f in dataclasses.fields(SemisupConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxSemisupConfig)}
    assert port == ref
