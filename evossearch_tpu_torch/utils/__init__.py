from .logging import get_logger, StageTimer, Counters

__all__ = ["get_logger", "StageTimer", "Counters"]
