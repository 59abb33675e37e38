from fovealseg_torch.configs.cfg_node import CfgNode
from fovealseg_torch.configs.defaults import get_default_cfg

__all__ = ["CfgNode", "get_default_cfg"]
