"""The released POEM configurations (``configs/release/train_*.yaml``) as Python data.

``MEDIUM`` holds the ``TRAIN``, ``MODEL`` and ``DATA_PRESET`` sections of
``train_medium.yaml``, copied verbatim: the machine that runs the port has
no YAML parser, so these dicts are the port's source for the models.
``SMALL``, ``LARGE`` and ``HUGE`` are medium at another width (128, 512,
1024; huge also has its own schedule), ``MEDIUM_MANO`` is medium with the
parametric (MANO pose and shape) output. A CPU test checks each against
its YAML file.
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
