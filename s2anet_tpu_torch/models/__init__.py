from .detector import S2ANet
from .fpn import FPN, PAN
from .head import S2ANetHead, s2anet_get_bboxes

__all__ = ["FPN", "PAN", "S2ANet", "S2ANetHead", "s2anet_get_bboxes"]
