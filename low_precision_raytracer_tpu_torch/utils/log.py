"""Logging: `warn` and `get_logger`, copied from
`low_precision_raytracer_tpu/utils/log.py` (a warning names its caller's
file:line and function)."""

from __future__ import annotations

import inspect
import logging

_logger = logging.getLogger("lprt_torch")
if not _logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(levelname)s %(name)s: %(message)s"))
    _logger.addHandler(_h)
    _logger.setLevel(logging.INFO)


def get_logger(name: str | None = None) -> logging.Logger:
    return _logger if name is None else _logger.getChild(name)


def warn(msg: str) -> None:
    """Log a warning prefixed with the caller's file:line and function."""
    frame = inspect.currentframe()
    caller = frame.f_back if frame is not None else None
    if caller is not None:
        info = inspect.getframeinfo(caller)
        _logger.warning("%s:%d <%s> %s", info.filename, info.lineno, info.function, msg)
    else:  # pragma: no cover
        _logger.warning(msg)
