from fovealseg_torch.configs.cfg_node import CfgNode
from fovealseg_torch.configs.defaults import get_default_cfg

# Config keys that exist for surface parity but that the reference runtime
# never reads (the JAX package's list, ``fovealseg_tpu/configs/__init__.py``).
# Setting one is almost certainly a user error: warn instead of ignoring it
# quietly (ignoring it is the reference's behaviour).
DEAD_REFERENCE_KEYS = {
    "DATASET": ("check_dataload", "shuffle_list", "dataset_name", "list_test",
                "adjust_crop_range", "multi_scale_aug", "mirror_padding"),
    "MODEL": ("deconv", "fix_img_gradient"),
    "TRAIN": ("fov_location_step", "auto_fov_location_step", "gpu_threshold",
              "loss_fun", "loss_weight", "scale_weight", "sync_location",
              "weight_decay_fov", "fov_scale_weight_decay", "workers",
              "mini_batch_size", "s_entropy_weight"),
    "VAL": ("F_Xlr_only", "F_Xlr_acc_map_only", "all_F_Xlr_time",
            "expand_prediection_rate_patch", "foveated_expection",
            "hard_max_fov", "max_score", "multipro", "rename_eval_folder"),
    # the reference ships no test entry point: the TEST group is unreachable there
    "TEST": ("checkpoint", "result", "batch_size"),
}


def audit_dead_keys(cfg, logger=None) -> list[str]:
    """Warn for every dead-in-the-reference key set away from its default.
    Returns the keys warned about.

    Also warns for ``VAL.F_Xlr_low_scale`` > 1 (dead in the reference, live
    here: it changes eval numbers) and refuses to replicate
    ``TRAIN.opt_deform_LabelEdge_accrate != 1``, which in the reference turns
    the boolean ``zoom`` flag of a parameter group into a float and freezes
    the foveation branch after one learning-rate adjustment."""
    import logging

    logger = logger or logging.getLogger("fovealseg")
    defaults = get_default_cfg()
    hits = []
    for group, keys in DEAD_REFERENCE_KEYS.items():
        for k in keys:
            if getattr(getattr(cfg, group), k) != getattr(getattr(defaults, group), k):
                hits.append(f"{group}.{k}")
                logger.warning(
                    "%s.%s is set but is a dead config key in the reference "
                    "(never read by its runtime); ignoring it reproduces "
                    "reference behavior", group, k,
                )
    if cfg.VAL.F_Xlr_low_scale not in (0, 1):
        hits.append("VAL.F_Xlr_low_scale")
        logger.warning(
            "VAL.F_Xlr_low_scale=%s: dead in the reference but live here: the "
            "saliency input is downscaled %sx at inference, so eval numbers "
            "differ from a reference run with the same config; set 0 for "
            "reference behavior", cfg.VAL.F_Xlr_low_scale, cfg.VAL.F_Xlr_low_scale,
        )
    if cfg.TRAIN.opt_deform_LabelEdge_accrate != 1.0:
        hits.append("TRAIN.opt_deform_LabelEdge_accrate")
        logger.warning(
            "TRAIN.opt_deform_LabelEdge_accrate=%s: in the reference this "
            "multiplies the boolean param_group['zoom'] flag, which freezes "
            "the foveation branch after one LR adjustment; refusing to "
            "replicate the bug, treating it as 1.0",
            cfg.TRAIN.opt_deform_LabelEdge_accrate,
        )
    return hits


__all__ = ["CfgNode", "get_default_cfg", "audit_dead_keys", "DEAD_REFERENCE_KEYS"]
