"""Persisted autotuner warm-start profiles (the JAX package's
``tuning/profile.py``; the same JSON document, so a profile either package
wrote loads into the other).

With ``autotune_profile_path`` set, the dispatcher loads the tuners' rung
tables from this JSON sidecar when it is built and the manager writes them
back at ``stop()``: a restarted process starts at the learned rungs, with
the measured neighbour totals in place. The profile is advice, never a
correctness surface: a missing, torn or stale file is a cold start (logged
at WARNING, never raised), and rungs no longer on a ladder are dropped on
restore. Writes are atomic (a temporary file, then a rename).
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from typing import Dict, Optional

logger = logging.getLogger("s3shuffle_tpu_torch.tuning")

PROFILE_VERSION = 1


def save_profile(path: str, scan_tuner=None, commit_tuner=None) -> bool:
    """Dump both tuners' rung tables to ``path`` (atomic). Returns False —
    with a WARNING — on any I/O failure; the live tuners are unaffected."""
    doc: Dict = {"version": PROFILE_VERSION, "tuners": {}}
    if scan_tuner is not None:
        doc["tuners"]["scan"] = scan_tuner.export_profile()
    if commit_tuner is not None:
        doc["tuners"]["commit"] = commit_tuner.export_profile()
    try:
        parent = os.path.dirname(os.path.abspath(path))
        fd, tmp = tempfile.mkstemp(prefix=".autotune-profile-", dir=parent)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
    except OSError as e:
        logger.warning("autotune profile dump to %s failed: %s", path, e)
        return False
    return True


def load_profile(path: str) -> Optional[Dict]:
    """Read a profile document, or None (with a WARNING for anything other
    than the file simply not existing yet — first run is not an error)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        logger.warning("autotune profile at %s unreadable: %s", path, e)
        return None
    if not isinstance(doc, dict) or doc.get("version") != PROFILE_VERSION:
        logger.warning(
            "autotune profile at %s has unsupported shape/version %r",
            path, doc.get("version") if isinstance(doc, dict) else type(doc),
        )
        return None
    return doc


def load_into(path: str, scan_tuner=None, commit_tuner=None) -> bool:
    """Load ``path`` and restore it into the given tuners. Returns True when
    a profile was found and applied."""
    doc = load_profile(path)
    if doc is None:
        return False
    tuners = doc.get("tuners", {})
    if scan_tuner is not None and isinstance(tuners.get("scan"), dict):
        scan_tuner.restore_profile(tuners["scan"])
    if commit_tuner is not None and isinstance(tuners.get("commit"), dict):
        commit_tuner.restore_profile(tuners["commit"])
    logger.info("autotune warm-start profile loaded from %s", path)
    return True
