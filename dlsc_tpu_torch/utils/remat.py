"""Names for the remat policies: the JAX package's ``checkpoint_name``.

``remat_tag(name)`` names the ops that the code inside it runs;
``models/vit.py``'s selective-checkpoint policies read ``current_tag()`` to
decide which outputs a rematerialised block keeps. Tags are set only inside
``tagging()``, which ``models/vit.py`` enters inside each checkpointed
block; elsewhere (serving, a forward without remat) ``remat_tag`` returns
one shared no-op context. The state is per thread, since the recompute runs
on the backward's thread, and the recompute runs the same code, so it
enters ``tagging()`` and sets the same tags.
"""

from __future__ import annotations

import contextlib
import threading

_STATE = threading.local()
_NO_TAG = contextlib.nullcontext()


class _Tag:
    __slots__ = ("name", "prev")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        self.prev = getattr(_STATE, "name", None)
        _STATE.name = self.name

    def __exit__(self, *exc) -> None:
        _STATE.name = self.prev


def remat_tag(name: str):
    """A context that names the ops run inside it ``name``, inside
    ``tagging()``; a no-op elsewhere."""
    return _Tag(name) if getattr(_STATE, "tagging", False) else _NO_TAG


@contextlib.contextmanager
def tagging():
    """Let ``remat_tag`` set tags while the code inside runs."""
    prev = getattr(_STATE, "tagging", False)
    _STATE.tagging = True
    try:
        yield
    finally:
        _STATE.tagging = prev


def current_tag() -> str | None:
    return getattr(_STATE, "name", None)
