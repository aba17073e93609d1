"""Benchmark harness (PyTorch port): problem sweep, cached runs, metrics,
plots, CLI; the momentum sweep, the wall-to-gap and restart benches, and
the weak-scaling bench (:mod:`zfista_tpu_torch.bench.scaling`)."""

from zfista_tpu_torch.bench.harness import (
    benchmark,
    initialize_problems,
    load_or_run_results,
    main,
)

__all__ = ["benchmark", "initialize_problems", "load_or_run_results", "main"]
