"""The released POEM configurations (``configs/release/train_*.yaml``) as Python data.

``MEDIUM`` holds the ``TRAIN``, ``MODEL`` and ``DATA_PRESET`` sections of
``train_medium.yaml``, copied verbatim: the machine that runs the port has
no YAML parser, so these dicts are the port's source for the models.
``SMALL``, ``LARGE`` and ``HUGE`` are medium at another width (128, 512,
1024; huge also has its own schedule), ``MEDIUM_MANO`` is medium with the
parametric (MANO pose and shape) output. ``SYNTHETIC`` holds the seven
``configs/synthetic_*.yaml`` (the ResNet-18 model on the synthetic
generator), each whole: smoke verbatim, the others as the changes they make
to it. A CPU test checks each against its YAML file.

``BASELINES`` holds the ``MODEL`` sections of the two multi-view baselines,
PETR and MVP, at the JAX package's defaults (no config file ships them):
ResNet-34 GN, embed 256, 6 decoder layers, 256 px crops of 8 views.
"""

import copy

MEDIUM = {
    "TRAIN": {'MANUAL_SEED': 1,
              'BATCH_SIZE': 32,
              'EPOCH': 10,
              'OPTIMIZER': 'adam',
              'LR': 0.0001,
              'SCHEDULER': 'StepLR',
              'LR_DECAY_GAMMA': 0.1,
              'LR_DECAY_STEP': [7],
              'LOG_INTERVAL': 10,
              'GRAD_CLIP_ENABLED': True,
              'GRAD_CLIP': {'TYPE': 2, 'NORM': 1.0},
              'WEIGHT_DECAY': 0.0},
    "MODEL": {   'TYPE': 'PtEmbedMultiviewStereoV2',
        'PRETRAINED': None,
        'BACKBONE': {'TYPE': 'HRNet', 'WIDTH': 40, 'NORM': 'gn'},
        'HEAD': {   'TYPE': 'POEM_Generalized_Head',
                    'TRANSFORMER': {   'TYPE': 'PtEmbedTRv4',
                                       'N_BLOCKS': 3,
                                       'INPUT_FEAT_DIM': 256,
                                       'NUM_ATTENTION_HEADS': 4,
                                       'DROPOUT': 0.1,
                                       'BPS_FEAT_DIM': 4096,
                                       'N_NEIGHBOR': 32,
                                       'N_NEIGHBOR_QUERY': 32,
                                       'PARAMETRIC_OUTPUT': False},
                    'POSITIONAL_ENCODING': {   'TYPE': 'SinePositionalEncoding3D',
                                               'NUM_FEATS': 128,
                                               'NORMALIZE': True},
                    'NUM_QUERY': 799,
                    'NUM_PREDS': 3,
                    'DEPTH_NUM': 32,
                    'POSITION_RANGE': [-0.6, -0.6, 0.0, 0.6, 0.6, 1.2],
                    'LID': False,
                    'DEPTH_START': 0.0,
                    'DEPTH_END': 1.2,
                    'POINTS_FEAT_DIM': 256,
                    'EMBED_DIMS': 256,
                    'IN_CHANNELS': 160,
                    'CENTER_SHIFT': True,
                    'N_SAMPLE': 4096,
                    'RADIUS_SAMPLE': 0.1,
                    'CAM_FEAT_MERGE': 'attn',
                    'QUERY_TYPE': 'KPT'},
        'LOSS': {   'JOINTS_LOSS_TYPE': 'l2',
                    'VERTICES_LOSS_TYPE': 'l1',
                    'HEATMAP_JOINTS_WEIGHT': 10.0,
                    'JOINTS_LOSS_WEIGHT': 1.0,
                    'VERTICES_LOSS_WEIGHT': 1.0,
                    'JOINTS_2D_LOSS_WEIGHT': 1.0,
                    'VERTICES_2D_LOSS_WEIGHT': 0.0}},
    "DATA_PRESET": {   'BBOX_EXPAND_RATIO': 2.0,
        'IMAGE_SIZE': [256, 256],
        'CENTER_IDX': 0,
        'NUM_JOINTS': 21,
        'NUM_VERTS': 778,
        'WITH_HEATMAP': True,
        'HEATMAP_SIZE': [32, 32],
        'HEATMAP_SIGMA': 2.0},
}


def _derive(width=None, train=None, transformer=None, loss=None):
    """MEDIUM with the three width keys set to ``width`` and the given
    ``TRAIN``, ``MODEL.HEAD.TRANSFORMER`` and ``MODEL.LOSS`` entries added."""
    cfg = copy.deepcopy(MEDIUM)
    head = cfg["MODEL"]["HEAD"]
    if width is not None:
        head["EMBED_DIMS"] = head["POINTS_FEAT_DIM"] = width
        head["TRANSFORMER"]["INPUT_FEAT_DIM"] = width
    cfg["TRAIN"].update(train or {})
    head["TRANSFORMER"].update(transformer or {})
    cfg["MODEL"]["LOSS"].update(loss or {})
    return cfg


SMALL = _derive(width=128)
LARGE = _derive(width=512)
HUGE = _derive(width=1024, train={"MANUAL_SEED": 2, "EPOCH": 15, "LR": 1e-5,
                                  "SCHEDULER": "CosineLR", "LR_MIN": 1e-7})
MEDIUM_MANO = _derive(transformer={"PARAMETRIC_OUTPUT": True, "TRANSFORMER_CENTER_IDX": 9},
                      loss={"POSE_LOSS_WEIGHT": 0.001, "SHAPE_LOSS_WEIGHT": 0.0005})

# the released tiers by the name of their YAML file (configs/release/train_<name>.yaml)
RELEASE = {"small": SMALL, "medium": MEDIUM, "medium_MANO": MEDIUM_MANO, "large": LARGE,
           "huge": HUGE}


SYNTHETIC_SMOKE = {
    "TRAIN": {'MANUAL_SEED': 1, 'BATCH_SIZE': 4, 'EPOCH': 1, 'OPTIMIZER': 'adam', 'LR': 0.001,
              'SCHEDULER': 'constant', 'LOG_INTERVAL': 5, 'GRAD_CLIP_ENABLED': True,
              'GRAD_CLIP': {'TYPE': 2, 'NORM': 1.0}},
    "DATASET": {'TRAIN': {'TYPE': 'Synthetic', 'VIEW_MAX': 2, 'IMAGE_SIZE': 64, 'EPOCH_SIZE': 64},
                'TEST': {'TYPE': 'Synthetic', 'VIEW_MAX': 2, 'IMAGE_SIZE': 64, 'EPOCH_SIZE': 16}},
    "DATA_PRESET": {'IMAGE_SIZE': [64, 64], 'CENTER_IDX': 0, 'NUM_JOINTS': 21, 'NUM_VERTS': 778},
    "MODEL": {
        'TYPE': 'PtEmbedMultiviewStereoV2',
        'PRETRAINED': None,
        'BACKBONE': {'TYPE': 'resnet18', 'NORM': 'gn'},
        'HEAD': {'TYPE': 'POEM_Generalized_Head',
                 'TRANSFORMER': {'TYPE': 'PtEmbedTRv4', 'N_BLOCKS': 2, 'INPUT_FEAT_DIM': 64,
                                 'NUM_ATTENTION_HEADS': 4, 'DROPOUT': 0.1, 'BPS_FEAT_DIM': 256,
                                 'N_NEIGHBOR': 8, 'N_NEIGHBOR_QUERY': 8},
                 'POSITIONAL_ENCODING': {'NUM_FEATS': 32, 'NORMALIZE': True},
                 'NUM_QUERY': 799,
                 'NUM_PREDS': 2,
                 'DEPTH_NUM': 8,
                 'POSITION_RANGE': [-0.6, -0.6, 0.0, 0.6, 0.6, 1.2],
                 'LID': False,
                 'DEPTH_START': 0.0,
                 'DEPTH_END': 1.2,
                 'POINTS_FEAT_DIM': 64,
                 'EMBED_DIMS': 64,
                 'IN_CHANNELS': 128,
                 'N_SAMPLE': 256,
                 'RADIUS_SAMPLE': 0.1,
                 'CAM_FEAT_MERGE': 'attn',
                 'QUERY_TYPE': 'KPT'},
        'LOSS': {'JOINTS_LOSS_TYPE': 'l2', 'VERTICES_LOSS_TYPE': 'l1',
                 'HEATMAP_JOINTS_WEIGHT': 10.0, 'JOINTS_LOSS_WEIGHT': 1.0,
                 'VERTICES_LOSS_WEIGHT': 1.0, 'JOINTS_2D_LOSS_WEIGHT': 1.0}},
}


def _overlay(base: dict, changes: dict) -> dict:
    """A deep copy of ``base`` with ``changes`` merged in, dict by dict."""
    out = copy.deepcopy(base)
    for k, v in changes.items():
        out[k] = _overlay(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) \
            else copy.deepcopy(v)
    return out


def _overfit(epoch, decay, views=None, size=None, render=False, ref_noise=None,
             parametric=False, joints_2d=None):
    """The fixed-set overfitting protocols: smoke's model without dropout on 64
    fixed samples (seed 7), batch 8, StepLR by 0.3 at ``decay``; ``views``
    valid views of as many, at ``size`` px, drawn skeletons with ``render``."""
    data = {"FIXED_SET": True, "SEED": 7}
    if views is not None:
        data.update(VIEW_MAX=views, IMAGE_SIZE=size, VIEW_RANGE=[views, views])
    if render:
        data["RENDER"] = True
    model = {"HEAD": {"TRANSFORMER": {"DROPOUT": 0.0}}}
    if ref_noise is not None:
        model["REF_NOISE"] = ref_noise
    if parametric:
        model["HEAD"]["TRANSFORMER"]["PARAMETRIC_OUTPUT"] = True
    if joints_2d is not None:
        model["LOSS"] = {"JOINTS_2D_LOSS_WEIGHT": joints_2d}
    changes = {
        "TRAIN": {"BATCH_SIZE": 8, "EPOCH": epoch, "SCHEDULER": "StepLR", "LR_DECAY_STEP": decay,
                  "LR_DECAY_GAMMA": 0.3, "LOG_INTERVAL": 40},
        "DATASET": {"TRAIN": dict(data), "TEST": dict(data, EPOCH_SIZE=64)},
        "MODEL": model}
    if size is not None:
        changes["DATA_PRESET"] = {"IMAGE_SIZE": [size, size]}
    return _overlay(SYNTHETIC_SMOKE, changes)


# the synthetic configs by the stem of their YAML file (configs/<name>.yaml)
SYNTHETIC = {
    "synthetic_smoke": SYNTHETIC_SMOKE,
    "synthetic_overfit": _overfit(240, [160, 200]),
    "synthetic_overfit_hires": _overfit(240, [160, 200], views=4, size=128, ref_noise=0.005),
    "synthetic_overfit_render": _overfit(240, [160, 200], views=4, size=128, render=True,
                                         ref_noise=0.003),
    "synthetic_overfit_gate": _overfit(480, [280, 400], views=8, size=128, render=True,
                                       ref_noise=0.004, joints_2d=5.0),
    "synthetic_overfit_gate_mano": _overfit(480, [280, 400], views=8, size=128, render=True,
                                            ref_noise=0.004, parametric=True, joints_2d=5.0),
    "synthetic_overfit_gate_mano_800": _overfit(800, [280, 400, 640], views=8, size=128,
                                                render=True, ref_noise=0.004, parametric=True,
                                                joints_2d=5.0),
}


# the multi-view baselines (models/petr.py, models/mvp.py) at the JAX defaults
_BASELINE_PRESET = {"CENTER_IDX": 0, "NUM_JOINTS": 21}
BASELINES = {
    "PETR": {
        "TYPE": "PETRMultiView",
        "BACKBONE": {"TYPE": "resnet34", "NORM": "gn"},
        "HEAD": {"TYPE": "PETRHead", "EMBED_DIMS": 256, "IN_CHANNELS": 256, "NUM_QUERY": 799,
                 "NUM_PREDS": 6, "NUM_REG_FCS": 2, "DEPTH_NUM": 32, "DEPTH_START": 0.0,
                 "DEPTH_END": 1.2, "LID": False,
                 "POSITION_RANGE": [-0.6, -0.6, 0.0, 0.6, 0.6, 1.2],
                 "POSITIONAL_ENCODING": {"NUM_FEATS": 128, "NORMALIZE": True}},
        "DATA_PRESET": dict(_BASELINE_PRESET),
    },
    "MVP": {
        "TYPE": "MVP",
        "BACKBONE": {"TYPE": "resnet34", "NORM": "gn"},
        "HEAD": {"TYPE": "MVPHead", "EMBED_DIMS": 256, "NUM_PREDS": 6, "NUM_HEADS": 8,
                 "NUM_POINTS": 4, "DIM_FEEDFORWARD": 1024, "DROPOUT": 0.1,
                 "POSITION_RANGE": [-0.6, -0.6, 0.0, 0.6, 0.6, 1.2], "IMAGE_SIZE": 256,
                 "CAMERA_NUM": 8},
        "DATA_PRESET": dict(_BASELINE_PRESET),
    },
}
