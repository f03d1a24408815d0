"""Checkpoints in the reference's run-directory layout:
``out_root/<model_ind>/`` holds ``latest.pytorch`` / ``best.pytorch``
(``{"net": state_dict, "optimiser": state_dict}``, the reference's own
segmentation save format), ``config.pickle`` (config, metric history,
last_epoch) and a readable ``config.txt``. Restart is not ported yet."""

import dataclasses
import os
import pickle

import torch

from iic_tpu_torch.train.config import config_to_str


def run_dir(config):
    d = os.path.join(config.out_root, str(config.model_ind))
    os.makedirs(d, exist_ok=True)
    return d


def save_meta(config, history, last_epoch, name="meta"):
    """config.pickle + config.txt (+ best_config.pickle for a best save).
    ``last_epoch`` is the epoch of the weights in latest.pytorch."""
    d = run_dir(config)
    meta = {"config": dataclasses.asdict(config), "history": history,
            "last_epoch": last_epoch}
    names = ["config.pickle"] + (["best_config.pickle"] if name == "best"
                                 else [])
    for fname in names:
        with open(os.path.join(d, fname), "wb") as f:
            pickle.dump(meta, f)
    with open(os.path.join(d, "config.txt"), "w") as f:
        f.write(config_to_str(config) + f"\nlast_epoch: {last_epoch}\n")


def save_checkpoint(config, net, optimizer, history, name="latest",
                    last_epoch=None):
    """Write <name>.pytorch and the run's meta files."""
    torch.save({"net": net.state_dict(), "optimiser": optimizer.state_dict()},
               os.path.join(run_dir(config), f"{name}.pytorch"))
    save_meta(config, history, last_epoch, name=name)
