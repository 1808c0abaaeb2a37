from .detector import S2ANet
from .head import S2ANetHead, s2anet_get_bboxes

__all__ = ["S2ANet", "S2ANetHead", "s2anet_get_bboxes"]
