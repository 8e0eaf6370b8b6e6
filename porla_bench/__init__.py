"""The benchmark of porla_tpu_torch on an NVIDIA H100 (`run.py`)."""
