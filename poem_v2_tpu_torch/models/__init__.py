"""POEM model modules (backbone, necks, head, decoder) and the auxiliary models in PyTorch."""

from .cmr import CMRG, create_cmr_model
from .pose2d import DarkPose, IntegralDeconvHead, IntegralPose, create_integral_pose
