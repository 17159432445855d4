"""The benchmark of ``ssrs_tpu_torch`` on NVIDIA GPUs (see ``run.py``)."""
