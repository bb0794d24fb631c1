"""Keep kernel outputs out of a checkpointed block's recompute.

The JAX decoder wraps each training block in ``nn.remat`` with the policy
``save_only_these_names("knn_idx", "knn_attn_out", "dense_attn_out")``
(``poem_v2_tpu/models/decoder.py``): the backward recomputes the block
but keeps what the kernels produced, so no kernel runs twice. The port's
counterpart: a block runs under ``torch.utils.checkpoint`` with
``context_fn=store.contexts``, and every kernel Function computes its
outputs through :func:`kernel_outputs`. In the block's first forward the
outputs are recorded in the store; in its recompute they are handed back
in the same order and the kernel does not launch.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, List, Optional, Tuple

import torch

_ACTIVE: contextvars.ContextVar[Optional[Tuple[str, "KernelOutputStore"]]] = \
    contextvars.ContextVar("poem_kernel_output_store", default=None)


class KernelOutputStore:
    """The kernel outputs of one checkpointed block call."""

    def __init__(self):
        self._outputs: List[Tuple[torch.Tensor, ...]] = []
        self._next = 0

    @contextlib.contextmanager
    def _mode(self, mode: str):
        if mode == "replay":
            self._next = 0
        token = _ACTIVE.set((mode, self))
        try:
            yield
        finally:
            _ACTIVE.reset(token)

    def contexts(self):
        """``context_fn`` for ``torch.utils.checkpoint``: (forward, recompute) contexts."""
        return self._mode("record"), self._mode("replay")

    def __len__(self) -> int:
        return len(self._outputs)


def kernel_outputs(compute: Callable[[], Tuple[torch.Tensor, ...]]) -> Tuple[torch.Tensor, ...]:
    """``compute()`` outside a checkpointed block; inside one, recorded on the
    first forward and replayed, without calling ``compute``, in the recompute."""
    active = _ACTIVE.get()
    if active is None:
        return compute()
    mode, store = active
    if mode == "record":
        out = compute()
        store._outputs.append(tuple(t.detach() for t in out))
        return out
    if store._next >= len(store._outputs):
        raise RuntimeError("recompute asked for more kernel outputs than the forward recorded")
    out = store._outputs[store._next]
    store._next += 1
    return tuple(t.detach() for t in out)
