"""Example scripts of the PyTorch port, run as modules:

    python -m zfista_tpu_torch.examples.cameraman_deblur [--device cuda]
    python -m zfista_tpu_torch.examples.tv_deblur
    python -m zfista_tpu_torch.examples.momentum_experiment
    python -m zfista_tpu_torch.examples.optimality_gap
    python -m zfista_tpu_torch.examples.large_lasso

Counterparts of the JAX package's ``examples/*.py`` with their flags plus
``--device`` (default ``"cuda"``; ``--device cpu`` asks for the CPU).  The
scripts that write files write under ``--out`` (default
``bench_results/torch/``).
"""
