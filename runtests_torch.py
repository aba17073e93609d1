"""Benchmark-suite CLI of the PyTorch port, the counterpart of
``runtests.py``: ``python runtests_torch.py [--large] [--no-plots]
[--out DIR] [--n-samples N] [--max-iter N] [--overwrite] [--verbose]
[--tol-internal-rel X] [--device cuda|cpu]``
(:func:`zfista_tpu_torch.bench.harness.main`; the batches solve on the card
unless ``--device cpu``).  Imports no JAX.
"""

from zfista_tpu_torch.bench.harness import main

if __name__ == "__main__":
    main()
