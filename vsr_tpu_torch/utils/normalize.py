"""Dataset intensity statistics (copy of ``vsr_tpu/utils/normalize.py``'s
``DATASET_STATS``; the tests pin the two equal).

The serving pipeline normalizes with ``(x - mean) / (std + 1e-10)`` and
denormalizes with ``clip(round(x * std + mean), 0, 255)``, the reference's
asymmetric pair.
"""

from __future__ import annotations

DATASET_STATS: dict[str, tuple[float, float]] = {
    "acdc": (54.089, 48.084),
    "dsb15": (51.193, 52.671),
}
