"""Fixtures for the port's test files that make their JAX references
cheaper to run, not different, and keep their torch work on one thread.
JAX is imported inside the fixtures: a file without JAX may take
``one_torch_thread``.

``jax_refs_at_lowest_level``: the file's JAX references compile at XLA's
lowest backend optimisation level. Each reference is compiled to run once
or twice, and its compile, not its run, takes the time: at the lowest
level XLA's CPU backend compiles a detector's value_and_grad in about half
the CPU time of its default. The graph passes are the same; LLVM's FMA
contraction is not, so the last bits of a result may differ: a reference
that they move past its tolerance (a cancelling determinant, several
optimizer steps) passes ``compiler_options=DEFAULT``.
A test file takes it with ``from torch_jax_refs import
jax_refs_at_lowest_level  # noqa: F401``: for the file's tests (the suite
runs each file in one process, ``--dist loadfile``) a function ``jax.jit``
wraps compiles with ``{"xla_backend_optimization_level": 0}`` when it is
called outside any trace (XLA takes compile options at the top level
only), the JAX package's own calls of ``jax.jit`` within those tests
included. Functions jitted when a module was imported keep their level.

``jax_merge_nms_jitted``: JAX's patch merge
(``sm3det_tpu.core.patch.split_merge.merge_det_by_patch_ids``) calls
``nms_rotated`` eagerly, once a base image and class, so every new box
count compiles each of its primitives anew; under this fixture it calls
the same function under one ``jax.jit`` a box count, which gives the same
detections (``test_torch_eval.py``'s merge test: 98.73 s, then 6.61 s, in
six-process ``-k torch`` runs before and after this fixture and
``one_torch_thread``).
"""

import pytest

LOWEST = {"xla_backend_optimization_level": 0}
# what a call passes to keep XLA's default level for its reference
DEFAULT = {}


class _LowestAtTopLevel:
    """``jax.jit(fun, **kwargs)`` that compiles at the lowest level when
    called at the top level; inside a trace it is the plain jit."""

    def __init__(self, real, fun, kwargs):
        self._plain = real(fun, **kwargs)
        self._lowest = real(fun, compiler_options=LOWEST, **kwargs)

    def __call__(self, *args, **kwargs):
        from jax._src.core import trace_state_clean
        fn = self._lowest if trace_state_clean() else self._plain
        return fn(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._lowest, name)


@pytest.fixture(scope="module", autouse=True)
def jax_refs_at_lowest_level():
    import jax
    real = jax.jit

    def jit(*args, **kwargs):
        if "compiler_options" in kwargs:
            return real(*args, **kwargs)
        if not args:                    # jax.jit(static_argnums=...)(fun)
            return lambda fun: _LowestAtTopLevel(real, fun, kwargs)
        return _LowestAtTopLevel(real, args[0], kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", jit)
        yield


@pytest.fixture(scope="module")
def jax_merge_nms_jitted():
    import jax

    from sm3det_tpu.core.patch import split_merge
    jitted = jax.jit(split_merge.nms_rotated,
                     static_argnames=("iou_threshold", "max_out",
                                      "score_thr", "row_chunk"),
                     compiler_options=DEFAULT)

    def nms_rotated(boxes, scores, iou_threshold, max_out, **kwargs):
        return jitted(boxes, scores, iou_threshold=iou_threshold,
                      max_out=max_out, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(split_merge, "nms_rotated", nms_rotated)
        yield


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the file's torch work: the suite runs six
    test processes on the host's cores, and each of them would otherwise
    start a thread a core."""
    import torch
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)
