"""K11, the nearest-patch search on bf16 inputs (``chip_smoke.py``
``check_nn``)."""
from portbench.counts.stage_loss_search import count  # noqa: F401
