"""Analysis: the mapping's robustness to fewer labels
(``iic_tpu/cli/analysis/overcluster_fewer_labels_example.py``):
re-evaluate a trained clustering run with only a fraction ``pc`` of the
mapping-assignment set (the same rows as the JAX loader for a seed):

    python -m iic_tpu_torch.cli.analysis.overcluster_fewer_labels_example \\
      --model_ind 640 --new_assign_set_szs_pc 1.0 0.1

The results are added to the run's stored config as
``assign_set_szs_pc_acc[str(pc)] = (num_imgs, acc)`` unless
``--dont_save``; ``--rewrite`` resets the stored dict first; BN runs on
the batch's statistics (the reference's default for this script) unless
``--use_eval``. Runs on cuda:0 unless ``main`` is given a device.
"""

import argparse
import os
import pickle


def main(argv=None, device=None):
    from iic_tpu_torch.cli.analysis.eval import eval_apply
    from iic_tpu_torch.data.pipeline import (
        MappingLoader, _twohead_partitions, cluster_create_dataloaders)
    from iic_tpu_torch.device import resolve_device
    from iic_tpu_torch.evals.cluster_eval import cluster_subheads_eval
    from iic_tpu_torch.infer import load_weights

    parser = argparse.ArgumentParser()
    parser.add_argument("--model_ind", type=int, required=True)
    parser.add_argument("--out_root", type=str, default="out")
    parser.add_argument("--new_assign_set_szs_pc", "--pcs", dest="pcs",
                        type=float, nargs="+",
                        default=[1.0, 0.5, 0.1, 0.01])
    parser.add_argument("--use_eval", default=False, action="store_true",
                        help="BN eval mode (the reference's default is "
                        "train mode for this script)")
    parser.add_argument("--dont_save", default=False, action="store_true")
    parser.add_argument("--rewrite", default=False, action="store_true")
    args = parser.parse_args(argv)
    if args.rewrite:
        assert not args.dont_save

    device = resolve_device(device)
    config, net, _, _ = load_weights(args.out_root, args.model_ind,
                                     device=device)
    apply_fn = eval_apply(config, net, train_mode=not args.use_eval)

    # partition tables are derived, not stored: rebuild them
    if config.twohead:
        _, _, map_a_parts, map_t_parts = _twohead_partitions(config)
    else:
        cluster_create_dataloaders(config, device=device)
        map_a_parts = config.mapping_assignment_partitions
        map_t_parts = config.mapping_test_partitions

    map_test = MappingLoader(config, map_t_parts, device=device)
    results = {}
    for pc in args.pcs:
        map_assign = MappingLoader(config, map_a_parts, device=device,
                                   truncate_pc=pc)
        num_imgs = len(map_assign.images)
        stats = cluster_subheads_eval(config, apply_fn, map_assign,
                                      map_test)
        results[str(pc)] = (num_imgs, stats["best"])
        print(f"pc {pc} ({num_imgs} imgs): best acc {stats['best']:.6f} "
              f"avg {stats['avg']:.6f}")

    if not args.dont_save:
        p = os.path.join(args.out_root, str(args.model_ind),
                         "config.pickle")
        with open(p, "rb") as f:
            meta = pickle.load(f)
        stored = ({} if args.rewrite else
                  dict(meta["config"].get("assign_set_szs_pc_acc", {})))
        stored.update(results)
        meta["config"]["assign_set_szs_pc_acc"] = stored
        with open(p, "wb") as f:
            pickle.dump(meta, f)
        print(f"stored assign_set_szs_pc_acc ({len(stored)} entries) "
              f"into {p}")
    return results


if __name__ == "__main__":
    main()
