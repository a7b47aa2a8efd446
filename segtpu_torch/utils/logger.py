"""The ``segtpu_torch`` logger's setup, and the per-epoch JSON ``Logger``.

Counterpart of ``segtpu/utils/logger.py``.
"""

from __future__ import annotations

import json
import logging


def setup_logging(level=logging.INFO) -> logging.Logger:
    """A stream handler on the ``segtpu_torch`` logger (once), at ``level``,
    not propagated to the root logger."""
    logger = logging.getLogger("segtpu_torch")
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s: %(message)s"))
        logger.addHandler(handler)
    logger.setLevel(level)
    logger.propagate = False
    return logger


class Logger:
    """Entries numbered from 1; ``str`` is their JSON (sorted keys, indent
    4, anything else by ``str``)."""

    def __init__(self):
        self.entries = {}

    def add_entry(self, entry):
        self.entries[len(self.entries) + 1] = entry

    def __str__(self):
        return json.dumps(self.entries, sort_keys=True, indent=4, default=str)
