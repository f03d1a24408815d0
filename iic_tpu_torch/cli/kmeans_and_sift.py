"""CLI: the k-means segmentation baseline on per-pixel colour or dense-SIFT
features (``iic_tpu/cli/kmeans_and_sift.py``):

    python -m iic_tpu_torch.cli.kmeans_and_sift --model_ind 900 \\
      --IID_model_ind 555 --max_num_train 1000000 [--do_sift] \\
      [--dataset_root DIR] [--out_root out]

- reloads the config of a fully unsupervised (mode IID) segmentation run,
  ``<out_root>/<IID_model_ind>/config.pickle``, and keeps its data
  settings, forced to raw colour (include_rgb, no sobel; in_channels 3, or
  4 with Potsdam's IR);
- colour mode takes every unmasked pixel's raw colour from the train
  pipeline's images, on the device; SIFT mode one 128-d OpenCV SIFT
  descriptor a SIFT_STEP x SIFT_STEP box at its central pixel, on the host
  (it needs cv2, which the H100 machine lacks);
- draws ``--max_num_train`` of them with
  ``np.random.default_rng(model_ind).choice`` (``--test_code``: the first
  10 000, from two batches);
- fits k = gt_k centroids, predicts every pixel of the mapping-assignment
  set, matches clusters to classes by the archetype's eval mode (Hungarian
  or many-to-one; ``orig_soft`` asserts False, as the JAX CLI does) and
  writes the matched accuracy and the centroids (numpy) to
  ``<out_root>/<model_ind>/config.pickle`` and ``config.txt``.

Departure from the JAX CLI: where it fits scikit-learn's
``MiniBatchKMeans(random_state=0)``, the port fits its own k-means
(``evals.kmeans_eval.KMeans(gt_k, seed=0)``: k-means++ and full-batch
Lloyd, best of 10, on the samples' device) and predicts with it, as the
port's k-means eval does. So the centroids, and with them the accuracy,
are not JAX's; given the same centroids the predictions, the match and
the accuracy are (tests/test_torch_kmeans_sift.py).

Runs on cuda:0 unless ``main`` is given a device, and raises when there
is no GPU.
"""

import argparse
import os
import pickle
import sys

import numpy as np
import torch

SIFT_DLEN = 128
SIFT_STEP = 10
TEST_CODE_SAMPLES = 10000


def _dense_sift(grey_u8, step=SIFT_STEP):
    """One 128-d descriptor per step x step box, at its central pixel (the
    grid arange(desc_side) * step + step // 2 on both axes). Returns
    (desc_side^2, 128) uint8, rows changing slowest."""
    import cv2

    h, w = grey_u8.shape
    desc_side = int(h / step)
    centres = np.arange(desc_side) * step + step // 2
    kps = [cv2.KeyPoint(float(x), float(y), float(step))
           for y in centres for x in centres]
    _, descs = cv2.SIFT_create().compute(grey_u8, kps)
    assert descs.shape == (desc_side * desc_side, SIFT_DLEN)
    return np.clip(descs, 0, 255).astype(np.uint8)


def _iter_train(pipeline):
    """The train pipeline's batches as (imgs uint8 NHWC, masks bool,
    labels None), on its device: the images before the pair augmentation,
    in raw colour."""
    for imgs, masks, _gen in pipeline.epoch(0):
        yield imgs, masks.bool(), None


def _iter_mapping(loader):
    """The mapping loader's batches as (imgs uint8 NHWC, masks bool, labels
    int32), on the images' device. With no sobel and include_rgb its
    images are raw colour / 255 (NCHW); ``* 255`` truncated to uint8 gives
    the levels back."""
    for imgs, labels, masks in loader:
        imgs = (imgs * 255.0).to(torch.uint8).permute(0, 2, 3, 1)
        yield (imgs, torch.from_numpy(np.asarray(masks)).to(imgs.device)
               .bool(), torch.from_numpy(np.asarray(labels, np.int32))
               .to(imgs.device))


def get_vectorised_colour_samples(config, batches, test_code=False):
    """Every unmasked pixel's raw colour, (n, in_channels) uint8 on the
    batches' device, in batch, image and row-major pixel order (and the
    pixels' labels (n,) where the batches carry labels)."""
    feats, labs = [], []
    for b_i, (imgs, masks, labels) in enumerate(batches):
        imgs, masks = torch.as_tensor(imgs), torch.as_tensor(masks)
        assert imgs.shape[1] == imgs.shape[2] == config.input_sz
        assert imgs.shape[3] == config.in_channels
        feats.append(imgs[masks])
        if labels is not None:
            labs.append(torch.as_tensor(labels)[masks])
        if test_code and b_i >= 1:
            break
    samples = torch.cat(feats).reshape(-1, config.in_channels)
    if not labs:
        return samples
    return samples, torch.cat(labs).reshape(-1)


def get_vectorised_sift_samples(config, batches, test_code=False):
    """One descriptor per SIFT_STEP box at the box-central pixel, on the
    host (numpy); the box-central pixel's mask decides inclusion and gives
    the label. Returns (n, 128) uint8 (and the labels (n,))."""
    import cv2

    desc_side = int(config.input_sz / SIFT_STEP)
    centres = np.arange(desc_side) * SIFT_STEP + SIFT_STEP // 2
    ch, cw = np.meshgrid(centres, centres, indexing="ij")
    ch, cw = ch.reshape(-1), cw.reshape(-1)

    feats, masks_c, labs = [], [], []
    for b_i, (imgs, masks, labels) in enumerate(batches):
        imgs, masks = _host(imgs), _host(masks)
        assert imgs.shape[1] == imgs.shape[2] == config.input_sz
        for i in range(len(imgs)):
            grey = cv2.cvtColor(np.ascontiguousarray(imgs[i, :, :, :3]),
                                cv2.COLOR_RGB2GRAY)
            feats.append(_dense_sift(grey))
            masks_c.append(masks[i][ch, cw])
            if labels is not None:
                labs.append(_host(labels)[i][ch, cw])
        if test_code and b_i >= 1:
            break
    keep = np.stack(masks_c)                      # (n, ds^2)
    samples = np.stack(feats)[keep].reshape(-1, SIFT_DLEN)
    if not labs:
        return samples
    return samples, np.stack(labs)[keep].reshape(-1)


def _host(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def raw_colour_config(config):
    """The archetype's config forced to raw single-pixel colour: rgb (and
    IR where the set has it), no sobel."""
    config.include_rgb = True
    config.no_sobel = True
    config.sobel = False
    if "Coco" in config.dataset:
        assert not config.using_IR
        config.in_channels = 3
    elif config.dataset == "Potsdam":
        assert config.using_IR
        config.in_channels = 4
    elif config.dataset.startswith("SyntheticSeg"):
        config.in_channels = 4 if config.using_IR else 3
    return config


def main(argv=None, device=None):
    from iic_tpu_torch.data.seg_pipeline import (
        segmentation_create_dataloaders)
    from iic_tpu_torch.device import resolve_device
    from iic_tpu_torch.evals.kmeans_eval import KMeans
    from iic_tpu_torch.evals.metrics import (
        accuracy, hungarian_match, original_match, reorder_preds)
    from iic_tpu_torch.train.config import config_from_dict, config_to_str

    parser = argparse.ArgumentParser()
    parser.add_argument("--model_ind", type=int, required=True)
    parser.add_argument("--out_root", type=str, default="out")
    parser.add_argument("--IID_model_ind", type=int, required=True)
    parser.add_argument("--max_num_train", type=int, required=True)
    parser.add_argument("--test_code", default=False, action="store_true")
    parser.add_argument("--do_sift", default=False, action="store_true")
    parser.add_argument("--dataset_root", type=str, default="",
                        help="override the archetype's stored dataset_root")
    args = parser.parse_args(argv)
    device = resolve_device(device)
    out_dir = os.path.join(args.out_root, str(args.model_ind))
    os.makedirs(out_dir, exist_ok=True)

    archetype_path = os.path.join(args.out_root, str(args.IID_model_ind),
                                  "config.pickle")
    print(f"Loading archetype config from: {archetype_path}")
    with open(archetype_path, "rb") as f:
        meta = pickle.load(f)
    config = config_from_dict(meta["config"])
    assert args.IID_model_ind == config.model_ind
    assert config.mode == "IID"  # compared against the fully unsupervised
    if args.dataset_root:
        config.dataset_root = args.dataset_root
    raw_colour_config(config)

    sample_fn = (get_vectorised_sift_samples if args.do_sift
                 else get_vectorised_colour_samples)

    assert config.num_dataloaders == 1
    train_pipe, map_assign, _map_test = segmentation_create_dataloaders(
        config, device=device)

    # colour samples lie on the device, SIFT's on the host
    samples = torch.as_tensor(sample_fn(config, _iter_train(train_pipe),
                                        test_code=args.test_code))
    print("got training samples")
    sys.stdout.flush()

    if args.test_code:
        print(f"testing code, taking {TEST_CODE_SAMPLES} samples only")
        samples = samples[:TEST_CODE_SAMPLES]
    else:
        num_train = min(samples.shape[0], args.max_num_train)
        print(f"taking {num_train} samples")
        chosen = np.random.default_rng(args.model_ind).choice(
            samples.shape[0], size=num_train, replace=False)
        samples = samples[torch.from_numpy(chosen).to(samples.device)]
        print(tuple(samples.shape))
    sys.stdout.flush()

    kmeans = KMeans(config.gt_k, seed=0).fit(samples.to(device))
    print("trained kmeans")
    sys.stdout.flush()

    # mapping_assignment doubles as the assessment set (in mode IID it is
    # the same set as mapping_test)
    assign_samples, assign_labels = sample_fn(
        config, _iter_mapping(map_assign), test_code=args.test_code)
    assign_preds = _host(kmeans.predict(
        torch.as_tensor(assign_samples).to(device))).astype(np.int32)
    assign_labels = _host(assign_labels).astype(np.int32)
    print("finished prediction for mapping assign/test data")
    sys.stdout.flush()

    if config.eval_mode == "hung":
        match = hungarian_match(assign_preds, assign_labels,
                                preds_k=config.gt_k, targets_k=config.gt_k)
    elif config.eval_mode == "orig":  # flat
        match = original_match(assign_preds, assign_labels,
                               preds_k=config.gt_k, targets_k=config.gt_k)
    elif config.eval_mode == "orig_soft":
        assert False  # not used, as in the JAX CLI
    else:
        raise ValueError(config.eval_mode)

    reordered = reorder_preds(assign_preds, match)
    found = np.zeros(config.gt_k)
    for pred_i, _target_i in match:
        found[pred_i] = 1
    assert found.sum() == config.gt_k  # each output cluster must be mapped

    acc = accuracy(reordered, assign_labels, config.gt_k)
    print(f"got acc {acc:.6f}")

    result_config = dict(vars(args))
    result_meta = {
        "config": result_config,
        "history": {"epoch_acc": [float(acc)]},
        "last_epoch": 0,
        "centroids": kmeans.cluster_centers_.cpu().numpy(),
        "match": match,
    }
    with open(os.path.join(out_dir, "config.pickle"), "wb") as f:
        pickle.dump(result_meta, f)
    with open(os.path.join(out_dir, "config.txt"), "w") as f:
        f.write(config_to_str(argparse.Namespace(**result_config))
                + f"\nepoch_acc: {[float(acc)]}\n")
    sys.stdout.flush()
    return acc


if __name__ == "__main__":
    main()
