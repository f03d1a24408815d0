"""Checkpoints in the reference's run-directory layout:
``out_root/<model_ind>/`` holds ``latest.pytorch`` / ``best.pytorch``
(``{"net": state_dict, "optimiser": state_dict}``, the reference's own
segmentation save format), ``config.pickle`` (config, metric history,
last_epoch) and a readable ``config.txt``. ``load_checkpoint`` restores a
run from them for ``--restart``."""

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


def load_checkpoint(config, net, optimizer, device, name="latest"):
    """Restore ``net`` and ``optimizer`` in place from <name>.pytorch (onto
    ``device``) and return (history, last_epoch) from config.pickle, which
    is read whatever ``name`` is. The optimiser's state carries the saved
    learning rate, so an lr step taken before the save is not taken again.
    config.pickle is the run's own file, written by ``save_meta``."""
    d = run_dir(config)
    saved = torch.load(os.path.join(d, f"{name}.pytorch"),
                       map_location=device, weights_only=True)
    net.load_state_dict(saved["net"])
    optimizer.load_state_dict(saved["optimiser"])
    with open(os.path.join(d, "config.pickle"), "rb") as f:
        meta = pickle.load(f)
    return meta["history"], meta["last_epoch"]


def save_plots(config, history):
    """plots.png in the run dir: eval accuracy, average sub-head accuracy
    and each head's epoch losses (and the double-eval lists under
    ``double_eval``). Writes nothing where matplotlib is not installed."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    ev = history["eval"]
    panels = [
        ("acc", ev.epoch_acc),
        ("avg_subhead_acc", ev.epoch_avg_subhead_acc),
        ("loss A", history["epoch_loss_head_A"]),
        ("loss no lamb A", history["epoch_loss_no_lamb_head_A"]),
        ("loss B", history["epoch_loss_head_B"]),
        ("loss no lamb B", history["epoch_loss_no_lamb_head_B"]),
    ]
    if getattr(config, "double_eval", False):
        panels += [("double eval acc", ev.double_eval_acc),
                   ("double eval avg subhead acc",
                    ev.double_eval_avg_subhead_acc)]
    fig, axarr = plt.subplots(len(panels), sharex=False, figsize=(20, 20))
    for ax, (title, data) in zip(axarr, panels):
        ax.plot(data)
        ax.set_title(title)
    fig.savefig(os.path.join(run_dir(config), "plots.png"))
    plt.close(fig)
