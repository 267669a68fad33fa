"""Diagnostics on stderr, payload JSON alone on stdout — the port of the
reference's ``kafka_assigner_tpu/utils/logging.py``: a stderr logger whose
level is the ``KA_LOG`` knob (default ERROR, as the reference's log4j
console config)."""
from __future__ import annotations

import logging
import sys

from .env import env_choice

_LOGGER_NAME = "kafka_assigner_tpu_torch"


def get_logger(child: str | None = None) -> logging.Logger:
    root = logging.getLogger(_LOGGER_NAME)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s %(message)s")
        )
        root.addHandler(handler)
        # env_choice folds case and falls back loudly on an unknown level.
        root.setLevel(env_choice("KA_LOG"))
        root.propagate = False
    return root.getChild(child) if child else root
