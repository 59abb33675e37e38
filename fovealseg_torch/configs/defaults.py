"""Default config tree.

The port's own copy of ``fovealseg_tpu/configs/defaults.py``: the same keys
and values, so the yaml configs and CLI dotlists written for the JAX package
(and for the reference it mirrors) load unchanged.
"""

from fovealseg_torch.configs.cfg_node import CfgNode


def get_default_cfg() -> CfgNode:
    _C = CfgNode()
    _C.DIR = "ckpt/ade20k-resnet50dilated-ppm_deepsup"

    # ------------------------------------------------------------------ DATASET
    _C.DATASET = CfgNode()
    _C.DATASET.root_dataset = "./data/"
    _C.DATASET.list_train = "./data/training.odgt"
    _C.DATASET.list_val = "./data/validation.odgt"
    _C.DATASET.grid_path = ""
    _C.DATASET.list_test = ""
    _C.DATASET.class_mapping = 0
    _C.DATASET.ignore_index = -2
    _C.DATASET.num_class = 150
    _C.DATASET.imgSizes = (300, 375, 450, 525, 600)
    _C.DATASET.imgMaxSize = 1000
    _C.DATASET.padding_constant = 8
    _C.DATASET.segm_downsampling_rate = 8
    _C.DATASET.random_flip = "Flip"
    _C.DATASET.multi_scale_aug = False
    _C.DATASET.adjust_crop_range = False
    _C.DATASET.mirror_padding = False
    _C.DATASET.binary_class = -1
    _C.DATASET.gt_gradient_rm_under_repre = 0.0
    _C.DATASET.repeat_sample = 0
    _C.DATASET.shuffle_list = True
    _C.DATASET.val_central_crop = False
    _C.DATASET.val_central_crop_shape = (300, 300)
    _C.DATASET.check_dataload = False
    _C.DATASET.dataset_marker_train = "sp400"
    _C.DATASET.dataset_marker_valid = "sp80"
    # new (replaces host-name keyed paths in DynamicFocus/preset.py:1-59)
    _C.DATASET.dataset_name = "lvis"
    _C.DATASET.data_cook_root = "./data_cook"
    _C.DATASET.coco_image_root = "./coco"

    # ------------------------------------------------------------------ MODEL
    _C.MODEL = CfgNode()
    _C.MODEL.arch_encoder = "resnet50dilated"
    _C.MODEL.arch_decoder = "ppm_deepsup"
    _C.MODEL.weights_encoder = ""
    _C.MODEL.weights_decoder = ""
    _C.MODEL.weights_net_saliency = ""
    _C.MODEL.weights_net_compress = ""
    _C.MODEL.fc_dim = 2048
    _C.MODEL.track_running_stats = True
    _C.MODEL.deconv = False
    _C.MODEL.rev_deform_opt = 51
    _C.MODEL.rev_deform_interp = "tri"
    _C.MODEL.loss_at_high_res = False
    _C.MODEL.saliency_net = "fovsimple"
    _C.MODEL.uniform_sample = ""
    _C.MODEL.saliency_output_size_short = 0
    _C.MODEL.gaussian_radius = 30
    _C.MODEL.gaussian_ap = 0.0
    _C.MODEL.in_dim = 3
    _C.MODEL.fix_img_gradient = False
    _C.MODEL.gt_gradient = False
    _C.MODEL.gt_gradient_intrinsic_only = True
    _C.MODEL.fix_gt_gradient = False
    _C.MODEL.ignore_gt_labels = []
    _C.MODEL.gt_grad_gaussian_blur_r = 1
    _C.MODEL.upsample = False

    # ------------------------------------------------------------------ TRAIN
    _C.TRAIN = CfgNode()
    _C.TRAIN.auto_batch = "manual"
    _C.TRAIN.auto_resume = False  # rebuild extra: when start_epoch==0 and
    # {DIR}/epoch_last exists, resume from it (start_epoch derived from the
    # checkpointed step) — preemption-safe restart for unattended runs
    _C.TRAIN.gpu_threshold = 0.65e6
    _C.TRAIN.batch_size_per_gpu = 1
    _C.TRAIN.num_gpus = 1
    _C.TRAIN.fov_location_step = 1
    _C.TRAIN.auto_fov_location_step = False
    _C.TRAIN.sync_location = "mean_mbs"
    _C.TRAIN.mini_batch_size = 1
    _C.TRAIN.num_epoch = 20
    _C.TRAIN.start_epoch = 0
    _C.TRAIN.epoch_iters = 5000
    _C.TRAIN.loss_fun = "FocalLoss"
    _C.TRAIN.loss_weight = []
    _C.TRAIN.scale_weight = ""
    _C.TRAIN.s_entropy_weight = -1.0
    _C.TRAIN.optim = "SGD"
    _C.TRAIN.fov_scale_pow = 1
    _C.TRAIN.fov_scale_lr = ""
    _C.TRAIN.fov_scale_weight_decay = ""
    _C.TRAIN.fov_scale_seg_only = False
    _C.TRAIN.lr_encoder = 0.02
    _C.TRAIN.lr_decoder = 0.02
    _C.TRAIN.lr_foveater = 0.02
    _C.TRAIN.lr_mult_encoder = 0.0001
    _C.TRAIN.lr_mult_decoder = 0.0001
    _C.TRAIN.lr_mult_saliency = 0.001
    _C.TRAIN.lr_mult_compress = 0.001
    _C.TRAIN.lr_pow = 0.9
    _C.TRAIN.scale_by_iter = False
    _C.TRAIN.beta1 = 0.9
    _C.TRAIN.weight_decay = 1e-4
    _C.TRAIN.weight_decay_fov = 1e-4
    _C.TRAIN.deep_sup_scale = 0.4
    _C.TRAIN.fix_bn = False
    _C.TRAIN.workers = 16
    _C.TRAIN.global_epoch = 1
    _C.TRAIN.disp_iter = 20
    _C.TRAIN.seed = 304
    _C.TRAIN.save_checkpoint = True
    _C.TRAIN.eval_per_epoch = 1
    _C.TRAIN.checkpoint_per_epoch = 2000
    _C.TRAIN.entropy_regularisation = False
    _C.TRAIN.entropy_regularisation_weight = 1.0
    _C.TRAIN.task_input_size = (1024, 2048)
    _C.TRAIN.task_input_size_eval = ()
    _C.TRAIN.saliency_input_size = (256, 512)
    _C.TRAIN.deform_pretrain_bol = True
    _C.TRAIN.deform_pretrain = 100
    _C.TRAIN.fix_deform_aft_pretrain = False
    _C.TRAIN.fix_deform_start_epoch = 2000
    _C.TRAIN.fix_deform_end_epoch = 2001
    _C.TRAIN.smooth_deform_2nd_start = 2001
    _C.TRAIN.smooth_deform_2nd_end = 2001
    _C.TRAIN.opt_deform_LabelEdge = False
    _C.TRAIN.fix_seg_start_epoch = 2000
    _C.TRAIN.fix_seg_end_epoch = 2001
    _C.TRAIN.opt_deform_LabelEdge_accrate = 1.0
    _C.TRAIN.opt_deform_LabelEdge_softmax = True
    _C.TRAIN.opt_deform_LabelEdge_norm = True
    _C.TRAIN.deform_joint_loss = False
    _C.TRAIN.edge_loss_scale = 100.0
    _C.TRAIN.fixed_edge_loss_scale = -1.0
    _C.TRAIN.edge_loss_pow = 0.9
    _C.TRAIN.edge_loss_scale_min = 0.0
    _C.TRAIN.stage_adjust_edge_loss = 1.0
    _C.TRAIN.adjust_edge_loss_start_epoch = 2000
    _C.TRAIN.adjust_edge_loss_end_epoch = 2001
    _C.TRAIN.def_saliency_pad_mode = "replication"
    _C.TRAIN.dynamic_task_input = (1, 1)
    _C.TRAIN.dynamic_saliency_relative_size = 1.0
    _C.TRAIN.deform_zero_bound = False
    _C.TRAIN.deform_zero_bound_factor = 1
    _C.TRAIN.skip_train_for_eval = False
    _C.TRAIN.train_eval_visualise = False
    # runtime-derived (mirrors cfg.TRAIN.max_iters / running_lr_* in the
    # reference driver, train_deform_semantic.py:313-317)
    _C.TRAIN.max_iters = 0
    _C.TRAIN.running_lr_encoder = 0.02
    _C.TRAIN.running_lr_decoder = 0.02
    _C.TRAIN.running_lr_foveater = 0.02

    # ------------------------------------------------------------------ VAL
    _C.VAL = CfgNode()
    _C.VAL.batch_size = 1
    _C.VAL.visualize = False
    _C.VAL.checkpoint = "epoch_20.pth"
    _C.VAL.hard_max_fov = False
    _C.VAL.max_score = False
    _C.VAL.central_crop = False
    _C.VAL.all_F_Xlr_time = False
    _C.VAL.rename_eval_folder = ""
    _C.VAL.multipro = False
    _C.VAL.dice = False
    _C.VAL.hd95 = False
    _C.VAL.F_Xlr_only = False
    _C.VAL.F_Xlr_acc_map_only = False
    _C.VAL.foveated_expection = True
    _C.VAL.ensemble = False
    _C.VAL.approx_pred_Fxlr_by_ensemble = False
    _C.VAL.F_Xlr_low_scale = 0
    _C.VAL.expand_prediection_rate = 1
    _C.VAL.expand_prediection_rate_patch = 1.0
    _C.VAL.no_upsample = False
    _C.VAL.write_pred = False
    _C.VAL.test = False
    _C.VAL.y_sampled_reverse = False
    _C.VAL.x_sampled_reverse = False
    _C.VAL.report_per_img_iou = False
    _C.VAL.trimap = False
    _C.VAL.trimap_dia_factor = 5
    _C.VAL.trimap_visual_check = False

    # ------------------------------------------------------------------ TEST
    _C.TEST = CfgNode()
    _C.TEST.batch_size = 1
    _C.TEST.checkpoint = "epoch_20.pth"
    _C.TEST.result = "./"

    # ------------------------------------------------------------------ TPU
    # Kept under the JAX package's group name so configs and dotlists
    # written for cli/infer.py load unchanged. The port reads
    # compute_dtype ("bfloat16" | "float32"), jfa_iters (0 = derive the
    # jump-flood round count from the grid) and async_checkpoint (write the
    # training checkpoints in a background thread after a host snapshot,
    # train/checkpoint.py::AsyncSaver); the rest are accepted and unused.
    # torch_ckpt_mirror stays unread on purpose: the port's checkpoint already
    # is the reference's 4-file .pth set that the JAX package's mirror writes.
    _C.TPU = CfgNode()
    _C.TPU.compute_dtype = "bfloat16"
    _C.TPU.sync_bn = True
    _C.TPU.data_axis = "data"
    _C.TPU.mesh_shape = (0,)
    _C.TPU.donate_state = True
    _C.TPU.jfa_iters = 0
    _C.TPU.scoremap_gather = "xla"
    _C.TPU.scoremap_gather_bf16 = False
    _C.TPU.profile_dir = ""
    _C.TPU.compile_cache_dir = "~/.cache/jax_fovealseg"
    _C.TPU.conv_pack = False
    _C.TPU.quantize = ""
    _C.TPU.torch_ckpt_mirror = False
    _C.TPU.async_checkpoint = True
    _C.TPU.tri_exact = True
    _C.TPU.dropout_rng_impl = "rbg"

    return _C
