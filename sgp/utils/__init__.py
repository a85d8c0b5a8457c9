from sgp.utils.config import Config, config
from sgp.utils.logging import logger

__all__ = ["Config", "config", "logger"]
