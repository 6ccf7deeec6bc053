"""Measurement and validation tools of the port; counterparts of the JAX
package's ``tools/quality_sweep.py``, ``tools/trace_budget.py`` and
``tools/scaling_measure.py``.  Each runs as ``python -m
dis_tpu_torch.tools.<name>``, on ``cuda`` unless ``--device cpu`` is
given; without a card a CUDA run raises."""
