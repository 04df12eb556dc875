from .target import TargetInfo, current_target

__all__ = ["TargetInfo", "current_target"]
