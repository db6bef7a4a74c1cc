"""Where the port keeps what it writes at run time.

Every default directory of the port lies under one root,
``<repo>/artifacts/torch``, apart from the JAX package's own directories
under ``<repo>/artifacts/`` (``dryrun/``, ``hillclimb/``,
``train_ckpt/``).  The two packages name their records alike
(``<arch>__<shape>__<mesh><tag>.json``) and lay out their checkpoints
alike, but the contents differ: a shared directory would hand one
package the other's records.  An explicit ``art=`` / ``--ckpt-dir``
still goes anywhere.
"""
from __future__ import annotations

from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
ART_ROOT = REPO_ROOT / "artifacts" / "torch"

#: the pod dry run's records and stage sidecars (``launch.dryrun``), read
#: by the roofline and the compiled rung
DRYRUN = ART_ROOT / "dryrun"
#: the measured rung's recorded traces, re-served by the replay rung
MEASURED = ART_ROOT / "measured"
#: ``scripts.optimize_all`` and ``scripts.hillclimb``'s outputs
HILLCLIMB = ART_ROOT / "hillclimb"
#: the train CLI's checkpoints and log
TRAIN_CKPT = ART_ROOT / "train_ckpt"
