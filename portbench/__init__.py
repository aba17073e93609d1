"""The benchmark of ``zfista_tpu_torch`` on one H100: see ``run.py``."""
