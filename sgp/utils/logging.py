"""Framework logger (counterpart of ``tsl/global_scope/logger.py:1-31``)."""
import logging
import sys

logger = logging.getLogger("sgp")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stdout)
    _h.setFormatter(logging.Formatter(
        "%(asctime)s [%(levelname)s] %(name)s: %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
    logger.propagate = False
