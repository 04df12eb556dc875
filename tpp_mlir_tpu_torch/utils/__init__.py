from .target import TargetInfo, current_target, resolve_device

__all__ = ["TargetInfo", "current_target", "resolve_device"]
