"""Optional NaN / invariant guard layer (``DIS_TPU_CHECK=1``);
counterpart of ``dis_tpu/utils/checks.py``.

The JAX package builds this on ``jax.experimental.checkify``; here:

- ``check(pred, msg)`` records a semantic invariant at a guard site
  (``ops/iclk.py::inverse_search``: finite ``u`` and ``Q``, the Q9
  policing invariant; the end of ``models/dis.py::dis_flow_padded``:
  finite flow).  It is a no-op unless ``DIS_TPU_CHECK=1`` is set AND a
  :func:`checked` wrapper is running, and then makes no tensor and reads
  nothing on the host;
- ``checked(fn)`` runs ``fn`` eagerly, collects each guard's predicate
  as a device tensor, reads all of them in one host sync after ``fn``
  returns, and raises ``RuntimeError`` with the first failing message.

``dis_flow`` takes a batch ``[B, H, W]`` itself, so ``checked`` covers a
batch (there is no ``checked_vmap``).  Guards never record under CUDA
graph capture: ``serving.aot_compile`` never wraps them, and a guard
site reached while a stream captures is skipped.

    DIS_TPU_CHECK=1 python -m dis_tpu_torch --device cuda seq 1 9
    # or in code:
    flow_fn = checks.checked(lambda a, b: dis_flow(a, b, cfg))
"""

from __future__ import annotations

import os
import threading

import torch

# Per thread: ``pending``, the (predicate, message, fmt) list of the
# innermost running checked() call, or absent.
_local = threading.local()


def enabled() -> bool:
    return os.environ.get("DIS_TPU_CHECK", "0") not in ("", "0")


def active() -> bool:
    """Whether a guard site should build its predicates now: checks are
    enabled, a :func:`checked` call is running, and no stream captures."""
    return (getattr(_local, "pending", None) is not None and enabled()
            and not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()))


def check(pred, msg: str, **fmt) -> None:
    """Record the invariant ``pred`` (a bool or a tensor, all of whose
    elements must be true) when :func:`active`; ``msg`` is formatted with
    ``fmt`` (tensors are read on the host) only if it fails."""
    if not active():
        return
    _local.pending.append((torch.as_tensor(pred).all(), msg, fmt))


def checked(fn):
    """Wrap ``fn`` so that the guard sites it reaches are live.  Returns a
    callable that runs ``fn``, then raises ``RuntimeError`` with the
    first failing invariant's message, else returns ``fn``'s result."""
    def run(*args, **kwargs):
        outer = getattr(_local, "pending", None)
        preds = _local.pending = []
        try:
            out = fn(*args, **kwargs)
        finally:
            _local.pending = outer
        if preds:
            ok = torch.stack([p.to(preds[0][0].device) for p, _, _ in preds]).cpu()
            for good, (_, msg, fmt) in zip(ok.tolist(), preds):
                if not good:
                    raise RuntimeError(msg.format(**{
                        k: v.item() if torch.is_tensor(v) and v.numel() == 1 else v
                        for k, v in fmt.items()}))
        return out

    return run
