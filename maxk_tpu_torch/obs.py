"""The program's own spans and set-up phases, on ``torch.profiler``.

``span(name)`` marks a stretch of host work in a profiler trace: a
``record_function`` event, to which the device operations launched
inside it belong by their launch times. With no profiler session active
it costs one attribute read and returns one shared no-op context: no
dispatcher call, no allocation, no ``torch.cuda.synchronize()``.

The spans, each under the prefix ``maxk.``:

- ``maxk.step`` (``Trainer.train_step``, ``DistTrainer.train_step``),
  which holds ``maxk.step.forward`` (the model and the loss),
  ``maxk.step.backward`` (``zero_grad`` and ``loss.backward()``),
  ``maxk.step.allreduce`` (``DistTrainer`` only: the gradients'
  all-reduce and their unpacking) and ``maxk.step.optimizer``;
- ``maxk.eval`` (``FitLoop.evaluate_masks``), which holds
  ``maxk.eval.forward`` (``eval_logits()``), ``maxk.eval.to_host`` and
  ``maxk.eval.metrics``. For ``micro_f1`` (every dataset but
  ogbn-proteins) ``.to_host`` holds the reductions of the logits to
  counts on their device (an argmax and one count a mask, or tp, fp and
  fn a mask) and the one copy of those few int64 values to the host, the
  evaluation's only synchronisation; ``.metrics`` holds the host's
  divisions of the counts. For ``rocauc`` ``.to_host`` copies the logits
  to a host numpy array and ``.metrics`` ranks them there.

- ``maxk.norm.forward`` (``BatchNorm.forward``, GNN_res's BatchNorm, in
  training and in evaluation) and ``maxk.norm.backward`` (the body of
  ``_BatchNorm.backward``, the training pass's written-out gradient), one
  each a layer.

Backward kernels are launched from autograd's device thread while the
main thread waits inside ``maxk.step.backward``, so their launch times
fall inside that span, and ``maxk.norm.backward`` opens on that thread.

``phase(name)`` times a stretch of a ``Trainer``'s construction on the
host clock (``time.perf_counter()``; no synchronise). Inside
``building()`` it adds its seconds to the phases of the Trainer being
built; while a profiler is on it is also the span ``maxk.<name>``.
Phases do not nest: one opened inside another adds nothing, and its
time stays with the outer one, so each second counts under at most one
phase. The phases (``BUILD_PHASES``):

- ``build.normalize``: ``CSRGraph.normalize`` and
  ``mean_transpose_values`` (``GraphBundle.from_csr``);
- ``build.transpose``: ``CSRGraph.transpose`` where a graph is not
  symmetric;
- ``build.segment_plan``: ``SegmentPlan.build``, ``generate_warp4`` and
  the plan's own small copies to the device;
- ``build.upload``: every other copy to the device of the graph (its
  CSR arrays, the mean transpose's values, a hub split's slab), the
  features, the labels and the training mask;
- ``build.model``: ``model_from_config``, its move to the device and the
  optimizer.

``last_build()`` gives the phases of the most recently built Trainer in
the process.

``counters()`` gives the program's counters by name, live, as
``ops.kernel_counters()`` gives the kernels' launches: a reader may zero
one between readings. Among the kernels, ``bn_sums``, ``bn_affine`` and
``bn_dx`` count BatchNorm's passes on the card
(``ops/cuda_batchnorm.py``): a GNN_res train step launches ``bn_sums``
twice a layer (its forward and its backward; the finishing launch is
not counted apart), ``bn_affine`` and ``bn_dx`` once a layer, and an
evaluation ``bn_affine`` once a layer. ``eval.metrics.device`` and
``eval.metrics.host`` count evaluations by where their metrics ran;
``norm.updates`` counts the moves of a BatchNorm's running statistics,
one a layer a train step and none in an evaluation.
"""

from __future__ import annotations

import contextlib
import threading
import time

from torch.autograd import profiler as _profiler

BUILD_PHASES = ("build.normalize", "build.transpose", "build.segment_plan",
                "build.upload", "build.model")

_NOOP = contextlib.nullcontext()
_counters = {"eval.metrics.device": 0, "eval.metrics.host": 0,
             "norm.updates": 0}
_local = threading.local()      # this thread's open build and phase
_last: dict = {}


def span(name: str):
    """``record_function(name)`` while a profiler session is active,
    else a shared no-op context."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _NOOP


@contextlib.contextmanager
def _timed_phase(name: str, phases: dict):
    _local.in_phase = True
    t0 = time.perf_counter()
    try:
        with span("maxk." + name):
            yield
    finally:
        phases[name] = phases.get(name, 0.0) + time.perf_counter() - t0
        _local.in_phase = False


def phase(name: str):
    """Time the body as set-up phase ``name`` of the Trainer being built
    on this thread; only a span outside ``building()`` or inside another
    phase."""
    phases = getattr(_local, "phases", None)
    if phases is None or getattr(_local, "in_phase", False):
        return span("maxk." + name)
    return _timed_phase(name, phases)


@contextlib.contextmanager
def building():
    """Collect the phases that run in the body on this thread. Yields the
    dict, phase name -> seconds, every one of ``BUILD_PHASES`` from 0;
    publishes it as ``last_build()`` once the body has ended without an
    exception."""
    global _last
    outer = getattr(_local, "phases", None)
    phases = _local.phases = dict.fromkeys(BUILD_PHASES, 0.0)
    try:
        yield phases
    finally:
        _local.phases = outer
    _last = dict(phases)


def last_build() -> dict:
    """The phases of the most recently built Trainer in the process, name
    -> seconds ({} before the first)."""
    return dict(_last)


def count(name: str) -> None:
    """Add one to the counter ``name``."""
    _counters[name] += 1


def counters() -> dict:
    """Every counter, name -> count, live: the module's own dict."""
    return _counters
