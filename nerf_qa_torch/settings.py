"""Global batch-size defaults.

A copy of ``nerf_qa_tpu/settings.py``. Reference behavior:
nerf_qa/settings.py (DEVICE_BATCH_SIZE=4, NR path) and
nerf_qa/settings_fr.py (DEVICE_BATCH_SIZE=32, FR path).
"""

DEVICE_BATCH_SIZE_NR = 4
DEVICE_BATCH_SIZE_FR = 32
